"""Block scheduler: the pipeline switch and the scheduler's error (the
``Scheduler`` class is not carried yet)."""

from .scheduler import SchedulerError, pipeline_on  # noqa: F401
