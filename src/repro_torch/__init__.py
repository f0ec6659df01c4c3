"""PyTorch + CUDA port of the Monarch serving path (``repro`` is the JAX
reference).  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; nothing here imports JAX or the ``repro`` package."""
