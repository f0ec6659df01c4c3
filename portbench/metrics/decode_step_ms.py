"""Decode a step, ms: the host clock around the program's decode (every
``transformer.decode_step`` of a batch and the tokens' copy to the host),
summed over the window, over the decode steps it ran (a batch decodes to
its longest answer)."""


def read(run):
    steps = sum(run.traffic.decode_tokens - 1 for b in run.batches)
    if not steps:
        return None
    return sum(b.decode_s for b in run.batches) / steps * 1e3
