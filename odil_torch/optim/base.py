"""The chunk planner of the device epoch loop (``odil_tpu/optim/base.py:95``)."""

__all__ = ["plan_chunks"]


def plan_chunks(epoch_start, epochs, task_epochs, max_chunk=512):
    """Yields chunk lengths so that every task epoch ends a chunk.

    task_epochs: sorted iterable of absolute epochs in
    (epoch_start, epoch_start + epochs] needing the host; None means every
    epoch does (chunk size 1)."""
    end = epoch_start + epochs
    e = epoch_start
    if task_epochs is None:
        while e < end:
            yield 1
            e += 1
        return
    tasks = [t for t in task_epochs if epoch_start < t <= end]
    for t in tasks:
        while e < t:
            n = min(t - e, max_chunk)
            yield n
            e += n
    while e < end:
        n = min(end - e, max_chunk)
        yield n
        e += n
