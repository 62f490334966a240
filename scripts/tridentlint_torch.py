#!/usr/bin/env python
"""tridentlint over the PyTorch port: protocol-invariant static analyzer.

Usage (from the repo root):

    python scripts/tridentlint_torch.py --baseline analysis/baseline_torch.json
    python scripts/tridentlint_torch.py --list-rules
    python scripts/tridentlint_torch.py --pretend-path runtime/injected.py /tmp/x.py

Scans ``src/repro_torch`` by default (``--root`` for another tree).
Exit status: 0 clean (modulo baseline), 1 when new findings appear.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
