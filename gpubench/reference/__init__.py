"""The plain reference that decides ``correct``.

Plain PyTorch and numpy only: nothing here imports the port or JAX.  The
inputs are derived again from the seed and the run directory's raw files
(``artifacts``, ``sampling``, ``codes``); the decoders, the DIA, the OSD
preparation, the discrepancy minima and the stopper walk are straight
implementations of the same semantics (``decode``, ``osd``).
"""
