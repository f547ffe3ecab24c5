"""Seconds a job in loading its images (pipeline/reconstruct.py,
data/views.py): the Initialization phase of the job's
time_measurements.txt, on the program's monotonic clock."""


def read(records):
    vals = [j["timing"]["initialization"] for j in records["jobs"]
            if j.get("timing") and j["error"] is None]
    return sum(vals) / len(vals) if vals else None
