from .checkpoint import load_params, save_params
from .logging import DecodeLog
from .tuning import TuneResult, autotune

__all__ = ["DecodeLog", "TuneResult", "autotune", "load_params",
           "save_params"]
