import sys

from tpu_swirld_torch.obs.report import main

sys.exit(main(sys.argv[1:]))
