import sys

from yak_tpu_torch.cli import main

sys.exit(main())
