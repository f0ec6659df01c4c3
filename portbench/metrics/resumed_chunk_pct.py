"""Share of the window's prompt chunks restored from KV slabs instead
of computed, %: the program's ``PrefixResumeEngine`` counters, window
deltas.  Nothing to read where the program does not resume."""


def read(run):
    c = run.counters
    if "engine.resumed_chunks" not in c:
        return None
    total = c["engine.resumed_chunks"] + c["engine.computed_chunks"]
    return 100.0 * c["engine.resumed_chunks"] / total if total else None
