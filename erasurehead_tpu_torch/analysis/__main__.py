"""``python -m erasurehead_tpu_torch.analysis [paths]`` — the lint CLI
without the full console entry point (no torch import on this path)."""

import sys

from erasurehead_tpu_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
