"""Front service: per-node module-ID message router."""

from .front import FrontService, InprocGateway, ModuleID  # noqa: F401
