"""The time to first token's share of the chip's bf16 peak, %: the
operations the prefills need (``count/flops.py``; restored tokens are
not computed) over the batches' summed time to first token (lookup and
prefill) times 989 TFLOP/s.  It bounds the rooflines of the kernels on
that path."""
from portbench.count import flops, peaks


def read(run):
    model = run.cell.config["model"]
    work = sum(flops.batch_flops(model, b.prompts.shape[1], b.restored,
                                 b.answers)[0] for b in run.batches)
    time_s = sum(b.first_token - b.start for b in run.batches)
    if not work or time_s <= 0:
        return None
    return 100.0 * work / (time_s * peaks.BF16_FLOPS)
