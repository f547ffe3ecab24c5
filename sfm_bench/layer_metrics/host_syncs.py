"""Host syncs a job: every synchronization of the host with the card that
the program made while its stage collector ran (torch's sync debug mode at
"warn", counted by utils/profiling.py), over the traced jobs; None where
the program counts none (the CPU, or a program without the counter)."""

from sfm_bench.layer_metrics._program import by_job


def read(records):
    vals = [t["host_syncs"] for _, t in by_job(records) if t["host_syncs"] is not None]
    return sum(vals) / len(vals) if vals else None
