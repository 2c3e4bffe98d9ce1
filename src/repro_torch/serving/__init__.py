"""Serving layer of the port: the batched decode engine and the SGP
request router (the paper's optimizer planning the pod-level
dispatch)."""
from .engine import Request, ServeConfig, ServingEngine
from .router import PodSpec, RateEstimator, RequestRouter, RouterConfig
