"""alloc_peak_gib (GiB), end to end: the most card memory the program held
allocated in the measured window (`torch.cuda.max_memory_allocated`,
reset at the window's start): card memory bounds the largest region one
card can solve, and speed bought with memory shows here."""


def read(run):
    return run.window_peak / float(1 << 30) if run.window_peak else None
