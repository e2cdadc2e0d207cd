import sys

from volcano_tpu_torch.cli.daemons import main

sys.exit(main())
