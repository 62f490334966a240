"""repro_torch -- the Trident 4PC runtime on PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The package mirrors ``repro``'s subpackage layout (``core``, ``kernels``,
``obs``, ``runtime``, ``serve``, ``train``) so each module's counterpart is
easy to find.  It imports ``torch`` and never ``jax`` or ``repro``: the
tests hold it bit-for-bit against the JAX package on the same seed.

Ring words are stored as ``int64`` (ell = 64) or ``int32`` (ell = 32):
add and mul wrap mod 2^ell, and every *logical* right shift is masked
(``core.ring.lshr``) because ``>>`` on a signed tensor sign-extends.

Entry points (``runtime.FourPartyRuntime``,
``serve.party_server.PartyPredictionServer``) run on ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit
device they raise.
"""
