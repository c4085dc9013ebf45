"""ms per 2^19-point pretraining batch, from the program's synced timer of
each block of epochs (SealTrainer.train_edit's pretraining)."""

from benchmark import harness


def read(trace: harness.Trace):
    batch = trace.values.get("batch_s")
    return 1e3 * sum(batch) / len(batch) if batch else None
