"""sparq_dist.sync_ms: the mean time of the engine's sync, from the
``on_sync`` hook's stamp (after the diff and the trigger norms, the device
synchronized) to the end of its step: compression, the x_hat update, the
mixing and the bits. Host clock, over every sync of the traced run's
window after its profiled steps."""


def read(record):
    ms = record.get("sync_ms") or []
    return sum(ms) / len(ms) if ms else None
