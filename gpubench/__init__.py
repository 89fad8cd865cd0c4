"""Benchmark of the PyTorch/CUDA port ``short_ldpc_decoding_osd_tpu_torch``.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a cell
needs beyond the code here is data found by name:

* ``configs/<config>.json``: a decoder configuration (run directory, code,
  variant, iterations, walk settings);
* ``traffic/<traffic>.json``: a traffic mix, whose ``kind`` names the loop
  in ``kinds/`` that drives it (``system`` or ``phase1``);
* ``checks/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell;
* ``metrics/<metric>.py``: the reader of one metric.

``reference/`` is the plain reference that decides ``correct``: plain
PyTorch and numpy that import nothing of the port.
"""
