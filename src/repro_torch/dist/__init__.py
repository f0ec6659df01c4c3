"""Distribution layer of the port: atomic checkpoints, gradient
compression, elastic restart, straggler handling and the partition-spec
rules (``sharding.py``) — the host side of ``repro/dist/``.  Placing
tensors by those specs needs several processes and is not ported yet.
Every module runs in one process without a card; the compressed
collective needs an initialised ``torch.distributed`` group."""
