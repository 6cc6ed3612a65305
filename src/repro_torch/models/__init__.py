"""Model path in torch: layers, attention (eager CPU path and the CUDA
kernels' dispatch), the dense transformer and the family dispatch."""
