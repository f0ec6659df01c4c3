"""The window's share of the chip's bf16 peak, %: the operations the
model needs for every token served in the window (prefills and each
request's own decode steps; tokens restored from slabs, and steps a
batch decodes past a row's answer, are not needed), counted from the
configuration by ``count/flops.py``, over the window's length times
989 TFLOP/s."""
from portbench.count import flops, peaks


def read(run):
    model = run.cell.config["model"]
    total = sum(sum(flops.batch_flops(model, b.prompts.shape[1], b.restored,
                                      b.answers))
                for b in run.batches)
    if not total or run.window_s <= 0:
        return None
    return 100.0 * total / (run.window_s * peaks.BF16_FLOPS)
