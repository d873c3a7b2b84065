"""``python -m compute_path_tracer_tpu_torch`` -> the CLI."""

import sys

from .app.cli import main

sys.exit(main())
