from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
