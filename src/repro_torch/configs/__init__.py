from repro_torch.configs.base import (LMConfig, MoEConfig, SSMConfig, XLSTMConfig,
                                HybridConfig, ShapeSuite, SHAPES,
                                SHAPES_BY_NAME, shape_applicable, reduced)

__all__ = ["LMConfig", "MoEConfig", "SSMConfig", "XLSTMConfig", "HybridConfig",
           "ShapeSuite", "SHAPES", "SHAPES_BY_NAME", "shape_applicable",
           "reduced"]
