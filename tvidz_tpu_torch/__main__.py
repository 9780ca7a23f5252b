import sys

from tvidz_tpu_torch.cli import main

sys.exit(main())
