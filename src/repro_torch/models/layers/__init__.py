"""Layers of the dense LM: RMSNorm, RoPE, grouped-query attention and
the SwiGLU MLP."""
