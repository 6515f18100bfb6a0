"""Serving-benchmark pieces on PyTorch: the BERT-base-class encoder, its
step probe and the stabilized profiling point (``bench_harness``), the
per-kernel breakdown of its forward on the card (``profile_encoder``),
and the port's copy of the perf analyzer that measures a served model
in process (``client_backend``, ``model_parser``, ``data_loader``,
``load_manager``, ``concurrency_manager``, ``inference_profiler``). The
request-rate manager, the report and the command line wait for a later
slice."""
