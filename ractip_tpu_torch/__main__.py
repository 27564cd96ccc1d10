"""python -m ractip_tpu_torch: the port's command-line interface (cli.py)."""

from .cli import main

raise SystemExit(main())
