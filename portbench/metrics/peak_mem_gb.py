"""Device memory peak inside the window, GB: ``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start."""


def read(run):
    b = run.peak_window_bytes
    return b / 1e9 if b else None
