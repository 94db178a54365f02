import sys

from advanced_hpc_lbm_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
