"""The window's wall time over the jobs it completed: seconds a
reconstruction, each ending in torch.cuda.synchronize()."""


def read(records):
    done = sum(1 for j in records["jobs"] if j["error"] is None)
    return records["window_s"] / done if done else None
