"""Model zoo of the port: the decoder LM, dense attention, MoE, Mamba2
(SSM) and hybrid families so far."""
from .config import ModelConfig, reduced
from .lm import LM
from . import module


def build_model(cfg: ModelConfig, device=None, impl=None) -> LM:
    """cfg -> LM on `device` (None: the card), weights uninitialised;
    load them with `convert.lm_params_from_numpy`.  Families the port
    does not run yet raise NotImplementedError naming their ROADMAP
    item."""
    return LM(cfg, device=device, impl=impl)
