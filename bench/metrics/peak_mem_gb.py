"""The device memory the window held at its peak (GB, 1e9 bytes):
``torch.cuda.max_memory_allocated()`` after the peak was reset at the
window's start."""


def read(facts):
    peak = facts.get("peak_window_bytes")
    return None if not peak else peak / 1e9
