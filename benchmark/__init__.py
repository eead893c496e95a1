"""Benchmark of the PyTorch/CUDA port, gsl_scattered_interpolation_torch.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell is made of is found by name, so that a new cell
is new files and entries:

* ``configs/<config>.json``: the deployment (system, sites, function,
  engine, precision) and the limits of its comparison;
* ``traffic/<mix>.json``: the traffic mix (loop, batch, pool, query
  distribution), read by :mod:`benchmark.generate`;
* the parts that those files name (:mod:`benchmark.parts`): ``systems/``,
  ``reference/``, ``functions/``, ``distributions/``, ``loops/``;
* ``metrics/<metric>.py``: a metric's reader, ``read(run)``.
"""
