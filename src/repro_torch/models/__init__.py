"""Model zoo of the port: the decoder LM (dense attention, MoE, Mamba2
(SSM), hybrid and VLM families) and the encoder-decoder LM."""
from .config import ModelConfig, reduced
from .lm import LM
from .encdec import EncDecLM
from . import module


def build_model(cfg: ModelConfig, device=None, impl=None):
    """cfg -> EncDecLM for the encoder-decoder family, else LM, on
    `device` (None: the card), weights uninitialised; load them with
    `convert.lm_params_from_numpy`."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device, impl=impl)
    return LM(cfg, device=device, impl=impl)
