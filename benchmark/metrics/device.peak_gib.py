"""The card's peak allocated memory over the measured window, resident
inputs included (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats`` at the window's start), in GiB; in a cell of
several cards, the fullest card's."""


def read(run, token=None):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes > 0 else None
