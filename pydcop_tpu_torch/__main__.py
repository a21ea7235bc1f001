import sys

from pydcop_tpu_torch.cli import main

sys.exit(main())
