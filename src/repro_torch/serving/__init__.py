"""Serving of the port (reference: ``repro.serving``): the LLM engine. The
diffusion engine and the plan cache come with ROADMAP.md queue 1 item 9."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
