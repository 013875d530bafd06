"""PyTorch/CUDA port of the SPARQ-SGD system in ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``models/``,
``configs/``, ``optim/``, ``data/``, ``dist/``, ``launch/``) so that every
module has an obvious counterpart in the JAX reference. It imports ``torch``,
``numpy`` and the standard library only: never ``jax`` and never ``repro``.
The tests are the only place where both packages meet.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); the Pallas kernels of the
reference become hand-written CUDA kernels under ``kernels/csrc``.
"""
