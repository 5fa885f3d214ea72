"""The port's copy of ``repro/obs/metrics.py``, which the scheduler reports
into. The tracer and timelines are not carried."""
