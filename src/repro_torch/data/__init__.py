from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                       SyntheticLMData, for_model)

__all__ = ["DataConfig", "Prefetcher", "SyntheticLMData", "for_model"]
