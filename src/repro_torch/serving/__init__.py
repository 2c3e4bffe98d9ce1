"""Serving layer of the port: the batched decode engine.  The SGP
request router (`serving/router.py` of the JAX package) comes with
ROADMAP item P11."""
from .engine import Request, ServeConfig, ServingEngine
