import sys

from historian_tpu.cli import main

if __name__ == "__main__":
    sys.exit(main())
