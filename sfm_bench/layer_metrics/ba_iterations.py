"""LM iterations that did work a job, over all its bundle adjustments (the
program's BARecorder, utils/profiling.py)."""


def read(records):
    vals = [j["ba_iterations"] for j in records["jobs"]
            if "ba_iterations" in j and j["error"] is None]
    return sum(vals) / len(vals) if vals else None
