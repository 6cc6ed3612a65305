"""What the drivers share: the program's configuration object, built
from the benchmark's configuration file."""
from __future__ import annotations

import dataclasses
from typing import Dict


def port_config(config: Dict):
    """The program's ``LMConfig`` holding every number of ``config`` that
    the program's configuration has a field for."""
    from repro_torch.configs.base import (HybridConfig, LMConfig, SSMConfig)
    nested = {"ssm": SSMConfig, "hybrid": HybridConfig}
    names = {f.name for f in dataclasses.fields(LMConfig)}
    kw = {k: (nested[k](**v) if k in nested else v)
          for k, v in config.items() if k in names}
    return LMConfig(**kw)
