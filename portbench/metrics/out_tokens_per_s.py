"""Output tokens served in the window, over the window's whole length
(from its start to the last batch's end), tokens/s: each request's own
answer length; what a batch decodes past a row's answer serves no one."""


def read(run):
    tokens = sum(int(b.answers.sum()) for b in run.batches
                 if b.served is not None)
    return tokens / run.window_s if run.window_s > 0 and tokens else None
