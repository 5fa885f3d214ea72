"""The port's copy of the framework-free scheduler core of ``repro/core``:
``latency_model``, ``requests``, ``chunking``, ``load_tracker`` and
``scheduler``, as they are (imports aside). The simulator engines and the
batch runner are not carried."""
