"""Serving of the port (reference: ``repro.serving``): the LLM engine, the
diffusion serving engine's emulated lanes and the persistent plan cache."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.diffusion_engine import (  # noqa: F401
    DiffusionRequest, DiffusionServingEngine)
from repro_torch.serving.plan_cache import PlanCache  # noqa: F401
