"""``python -m repro_torch.analysis``: run the static invariant matrix. Port
of ``repro/analysis/__main__.py``. The reference forces host devices for
its largest topology first; the port's collective checks start their own
gloo ranks, one per device position (``analysis.runner.run_ranks``)."""
import sys

from repro_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
