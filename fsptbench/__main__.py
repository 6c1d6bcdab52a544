import sys

from fsptbench.run import main

sys.exit(main())
