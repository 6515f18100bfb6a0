"""The benchmark of ``client_tpu_torch``, driven by data.

One process runs one cell (one entry of ``workloads`` in
``BENCHMARK.json``) once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell, configuration or metric sits in a
file of its own, found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: a model deployment (the published keys and
  values, the program's departures from them with the value each runs
  at, sizes assumed, serving knobs);
- ``workloads/<cell>.json``: the configuration, the driver and the
  traffic's parameters;
- ``drivers/<driver>.py``: one closed-loop generator per kind of traffic
  (``setup``, ``run``, ``release``, ``check``);
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per metric,
  ``read(record) -> float | None``, over the run's record;
- ``reference/``: plain float32 PyTorch forward passes of the
  architectures, which import nothing of the program;
- ``held.json``: cells whose files are whole but that are not in
  ``BENCHMARK.json``, with their entries in the manifest's form.

The program is ``client_tpu_torch``; nothing here imports JAX or the JAX
package, and the reference imports nothing of the program.
"""
