"""The port's set-up stages as the ``setup_*`` metrics read them.

The port keeps a set-up record for the whole process, whether or not
anything records (``utils.profiling.setup_snapshot``): one span a one-time
stage of its start, each with its self host seconds (its own, less the
set-up spans nested in it).  A metric reads the self seconds of its
stages, so the five add up to the port's share of ``setup_s`` and no
second counts twice.  A stage that did not run in the process (no card, no
kernel library) reads 0.0; a port without the record reads nothing.
"""

# metric -> the set-up spans whose self seconds it adds
READS = {
    "setup_import_s": ("setup.import",),
    "setup_device_s": ("setup.device",),
    "setup_load_s": ("setup.load_run", "setup.two_phase"),
    "setup_kernels_s": ("setup.kernels",),
    "setup_first_unit_s": ("setup.first_unit",),
}


def self_seconds(snapshot: dict, stages) -> float:
    """The self seconds of ``stages`` in a set-up snapshot, 0.0 for a
    stage it lacks."""
    spans = snapshot["spans"]
    return sum((spans[s]["self_seconds"] for s in stages if s in spans), 0.0)


def read(metric: str) -> float | None:
    """The reading of ``metric`` in this process; None where the port has
    no set-up record.  Raises where the port names no such stage, so a
    renamed stage fails the run and does not read 0.0."""
    from short_ldpc_decoding_osd_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "setup_snapshot", None)
    if snapshot is None:
        return None
    unknown = set(READS[metric]) - set(profiling.SETUP_STAGES)
    if unknown:
        raise KeyError(f"{metric}: the port has no set-up stage {sorted(unknown)}")
    return self_seconds(snapshot(), READS[metric])
