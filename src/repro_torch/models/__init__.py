"""Model path in torch: layers, attention (eager CPU path and the CUDA
kernels' dispatch), the transformer (dense and MoE FFNs), the recurrent
blocks (Mamba-2, xLSTM), the hybrid, and the family dispatch."""
