"""``python -m pyqmd_tpu_torch``: alias for the CLI (the reference's entry
point is ``python nuclear_sim.py``, nuclear_sim.py:615-617).
"""

import sys

from pyqmd_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
