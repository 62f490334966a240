"""FourPartyRuntime: the party-sliced execution engine
(``repro/runtime/runtime.py``).

Holds the four ``Party`` objects, the ``Transport``, the kernel backend
and the statically allocated PRF counter stream.  The counter and tag
order is the JAX package's, so a runtime seeded like a JAX
``FourPartyRuntime`` draws bit-identical streams and opens bit-identical
words.  All ring words live on ``device``: CUDA unless the caller asks
for the CPU.
"""
from __future__ import annotations

import torch

from ..core.algebra import PARTIES, CheckLedger, all_ok
from ..core.context import resolve_device
from ..core.prf import ThreefryKey
from ..core.ring import RING64, Ring
from ..obs import get_tracer
from .kernel_backend import MeteredKernels, TracedKernels, make_kernel_backend
from .party import Party, PartyKeys
from .transport import LocalTransport, Transport


class InlinePrep:
    """Preprocessing seam: every protocol acquires its data-independent
    randomness -- lambda/gamma shares, truncation pairs, conversion masks
    -- through ``rt.prep.acquire(tag, kind, build)``.  The three engines:

      * ``InlinePrep``              -- run ``build()`` here and now;
      * ``offline.store.DealPrep``  -- run ``build()`` (the dealer pass:
        offline messages move on the dealer's transport) and record the
        per-party material in a ``PrepStore`` under `tag`;
      * ``offline.store.OnlinePrep`` -- never call ``build()``; pop the
        recorded material from the store (use-once).

    ``skip_online`` tells protocols to stop after the offline half (deal
    mode, where shares carry only lambda components); ``consuming`` marks
    the online-only run, where PRF sampling is refused because all
    randomness must come from the store."""

    mode = "inline"
    skip_online = False
    consuming = False

    def acquire(self, tag: str, kind: str, build):
        return build()


class FourPartyRuntime:
    def __init__(self, ring: Ring = RING64, seed: int = 0,
                 transport: Transport | None = None,
                 malicious_checks: bool = True,
                 bitext_guard: int = 24, bitext_method: str = "mul",
                 norm_window: tuple = (4, 40), prep=None,
                 kernel_backend="hopper", device=None):
        self.ring = ring
        self.device = resolve_device(device)
        self.transport = transport if transport is not None \
            else LocalTransport()
        self.malicious_checks = malicious_checks
        self.prep = prep if prep is not None else InlinePrep()
        self.kernels = MeteredKernels(
            make_kernel_backend(kernel_backend, self.device))
        # share the transport's tracer (NetModelTransport forwards it) so
        # protocol spans and wire events land in one buffer; only a
        # tracing runtime wraps its kernel calls into spans
        self.tracer = getattr(self.transport, "tracer", None) or get_tracer()
        if self.tracer.enabled:
            self.kernels = TracedKernels(self.kernels, self.tracer,
                                         self.device)
        self.bitext_guard = bitext_guard
        self.bitext_method = bitext_method
        self.norm_window = norm_window
        master = ThreefryKey.from_seed(seed)
        self.parties = tuple(
            Party(i, PartyKeys(master, i), CheckLedger()) for i in PARTIES)
        self._counter = 0
        self._tagno = 0

    # -- PRF sampling (counter parity with the JAX runtime) -----------------
    def fresh_counter(self) -> int:
        c = self._counter
        self._counter += 1
        return c

    def sample(self, subset, shape) -> torch.Tensor:
        """Non-interactive joint sampling by `subset`; the value is derived
        from a key held by a member party (identical at every member)."""
        return self.sample_group([(subset, shape)])[0]

    def sample_bounded(self, subset, shape, bits: int) -> torch.Tensor:
        """Joint sampling of values uniform over [0, 2^bits)."""
        return self.sample_group([(subset, shape, bits)])[0]

    def sample_group(self, specs) -> list:
        """Several draws at once, ``(subset, shape)`` or ``(subset, shape,
        bits)`` each: the counters are taken in list order, so the words
        equal those of the same ``sample``/``sample_bounded`` calls in a
        row; the kernel backend draws the group in one launch."""
        if self.prep.consuming:
            # the online-only run draws ALL randomness from the PrepStore; a
            # PRF call here means a protocol path missed the prep seam
            raise RuntimeError(
                "PRF sampling during a PrepStore-backed online-only run: "
                "all offline randomness must come from the store")
        draws = [(self.parties[min(sp[0])].keys.subset_key(sp[0]),
                  self.fresh_counter(), sp[1],
                  sp[2] if len(sp) > 2 else None) for sp in specs]
        return self.kernels.prf_bits_group(draws, self.ring, self.device)

    # -- bookkeeping -------------------------------------------------------
    def next_tag(self, op: str) -> str:
        self._tagno += 1
        return f"{op}#{self._tagno}"

    def words(self, v) -> torch.Tensor:
        """Ring words (already encoded) as a tensor on this runtime's
        device."""
        return torch.as_tensor(v).to(device=self.device,
                                     dtype=self.ring.dtype)

    def encode(self, x) -> torch.Tensor:
        """Fixed-point encoding on this runtime's device."""
        return self.ring.encode(x, device=self.device)

    def abort_flag(self) -> bool:
        """OR over the four parties' check ledgers (any party aborts); the
        only place the checks are read back from the device."""
        return not all_ok([c for p in self.parties for c in p.ledger.checks])
