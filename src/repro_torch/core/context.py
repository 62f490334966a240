"""Trident execution context of the joint simulation: ring + keys + cost
tally + phase mode + device (``repro/core/context.py``).

A ``TridentContext`` is created per program run (per served batch).  It
provides:

  * PRF sampling with statically allocated counters, drawn on the context's
    device through the ``prf_mask`` kernel (``kernels.ops.lambda_masks_group``,
    one launch per group of draws): the same squares streams as the JAX
    package's, word for word;
  * the communication ``CostTally``;
  * malicious-security check collection (recompute-and-compare emulation of
    the paper's hash exchanges, folded into one abort flag);
  * the offline/online material channel that realizes the paper's
    offline-online paradigm as twin runs of the same program.

Modes:
  fused    -- offline + online inlined in one program (default).
  offline  -- runs only the data-independent part; every protocol pushes its
              preprocessing material (gamma shares, truncation pairs, ...)
              into ``materials``.
  online   -- consumes the materials of an offline run of the *same*
              program (identical call order), popped by index.

An online run skips the PRF draws of each protocol's offline branch but
takes the draws both modes take (``share``'s lambdas, BitExt's ``vsh_bool``
of the opened bit, ...).  So that those draws use the offline run's
counters, ``offer`` in offline mode records the counter with each material
(``Materials.counters``) and ``get_material`` sets the counter back to it:
the online words equal the fused run's.  (The JAX package's online run
keeps its own counter and opens other words past the first skipped draw.)

Loop bodies.  The JAX package runs layer stacks and query chunks as
``lax.scan`` bodies, traced once: every iteration takes the same PRF
counters under its own key (``scan_keys``: the iteration's key from
``jax.random.split`` replaces the master key, each subset's stream comes
from ``fold_in(key, subset_id)``).  The port runs those bodies as Python
loops (``nn.recurrent.scan_loop``) that set the counter back before each
iteration and set ``key_override`` through ``scan_keys``, so they draw the
JAX package's words.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels import ops
from .algebra import CheckLedger
from .costs import CostTally
from .prf import SetupKeys, ThreefryKey, make_setup_keys, subset_id
from .ring import RING64, Ring


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA;
    with no device given and no CUDA, refuse rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to "
                           "run the port on the CPU")
    return torch.device("cuda")


class Materials(list):
    """An offline run's materials, one entry per ``offer``, with the PRF
    counter the run had reached at each (``counters``)."""

    def __init__(self):
        super().__init__()
        self.counters: list[int] = []


@dataclasses.dataclass
class TridentContext:
    ring: Ring
    keys: SetupKeys
    tally: CostTally
    mode: str = "fused"                 # fused | offline | online
    malicious_checks: bool = True
    # Beyond-paper "component-collapsed" evaluation: the joint simulation
    # computes reconstructed wire values from collapsed lambda sums (4
    # matmuls per secure matmul instead of 16).  Identical communication
    # tallies, other PRF draws (no zero shares), so other words.
    collapse: bool = False
    # BitExt (Fig. 19) guard bits: |r| < 2^{ell-1-guard}; correctness holds
    # for |v| < 2^guard.
    bitext_guard: int = 24
    # "mul" = paper-faithful Fig. 19 (constant rounds, guarded r);
    # "ppa" = robust boolean-PPA msb (log ell rounds, no precondition).
    bitext_method: str = "mul"
    # Leading-one window [lo, hi) for the NR reciprocal/rsqrt normalization
    # (bit positions of the ring); covers reals in [2^{lo-f}, 2^{hi-f}).
    norm_window: tuple = (4, 40)
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self._counter = 0
        self.materials = Materials()
        self._mat_idx = 0
        self.ledger = CheckLedger()
        # inside a loop body (a JAX scan body): the iteration's key, which
        # stands in for the master key (scan_keys)
        self.key_override: ThreefryKey | None = None

    # --- PRF sampling ---------------------------------------------------
    def fresh_counter(self) -> int:
        c = self._counter
        self._counter += 1
        return c

    def sample(self, subset, shape) -> torch.Tensor:
        """Non-interactive joint sampling by `subset` (F_setup stream)."""
        return self.sample_group([(subset, shape)])[0]

    def sample_bounded(self, subset, shape, bits: int) -> torch.Tensor:
        """Uniform over [0, 2^bits) embedded in the ring."""
        return self.sample_group([(subset, shape, bits)])[0]

    def sample_group(self, specs, flat: bool = False):
        """Several draws, ``(subset, shape)`` or ``(subset, shape, bits)``
        each, with their counters taken in list order (the words of the
        same ``sample``/``sample_bounded`` calls in a row), in one
        ``prf_mask`` launch (up to MAX_STREAMS draws): a view per draw, or
        with `flat` the one buffer of their words, draw after draw."""
        return ops.lambda_masks_group(
            [(self._subset_key(sp[0]).data, self.fresh_counter(), sp[1],
              self.ring.ell - sp[2] if len(sp) > 2 else 0) for sp in specs],
            self.ring.dtype, self.device, flat=flat)

    def _subset_key(self, subset) -> ThreefryKey:
        if self.key_override is not None:
            return self.key_override.fold_in(subset_id(subset))
        return self.keys.subset_key(subset)

    @contextlib.contextmanager
    def scan_keys(self, key: ThreefryKey):
        """Use `key` (a loop iteration's key) as the PRF root inside a loop
        body; restores the previous root on exit."""
        prev = self.key_override
        self.key_override = key
        try:
            yield
        finally:
            self.key_override = prev

    # --- ring words on the context's device -------------------------------
    def words(self, v) -> torch.Tensor:
        """Ring words (already encoded) as a tensor on this context's
        device."""
        return torch.as_tensor(v).to(device=self.device,
                                     dtype=self.ring.dtype)

    def encode(self, x) -> torch.Tensor:
        """Fixed-point encoding on this context's device."""
        return self.ring.encode(x, device=self.device)

    # --- offline/online material channel ---------------------------------
    def put_material(self, mat) -> None:
        self.materials.append(mat)
        self.materials.counters.append(self._counter)

    def get_material(self):
        """The next material of the offline run, with the PRF counter set
        back to where that run recorded it."""
        mat = self.materials[self._mat_idx]
        self._counter = self.materials.counters[self._mat_idx]
        self._mat_idx += 1
        return mat

    def offer(self, mat):
        """fused: pass through; offline: record; online: replace with the
        recorded material."""
        if self.mode == "fused":
            return mat
        if self.mode == "offline":
            self.put_material(mat)
            return mat
        return self.get_material()

    # --- malicious-security checks (shared CheckLedger, algebra.py) -------
    def check_equal(self, a, b, tag: str = "") -> None:
        """Emulates a hash-consistency exchange: both senders' copies must
        agree.  Tampering flips the abort flag."""
        if not self.malicious_checks:
            return
        self.ledger.check_equal(a, b, tag)

    def abort_flag(self) -> bool:
        """False if all consistency checks passed (continue), True = abort;
        the only place the checks are read back from the device."""
        return self.ledger.abort_flag()


def make_context(ring: Ring = RING64, seed: int = 0, mode: str = "fused",
                 malicious_checks: bool = True, device=None,
                 **kw) -> TridentContext:
    """A fresh context; on CUDA unless `device` says otherwise (and refused
    without CUDA when no device is given)."""
    return TridentContext(ring=ring, keys=make_setup_keys(seed),
                          tally=CostTally(), mode=mode,
                          malicious_checks=malicious_checks,
                          device=resolve_device(device), **kw)
