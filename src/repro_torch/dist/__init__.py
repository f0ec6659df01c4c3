"""Distribution layer of the port: atomic checkpoints, gradient
compression, elastic restart and straggler handling — the host side of
``repro/dist/`` (the partition-spec rules, ``sharding.py``, come with
multi-device support).  Every module runs in one process without a card;
the compressed collective needs an initialised ``torch.distributed``
group."""
