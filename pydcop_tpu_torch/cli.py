"""`pydcop_tpu_torch` CLI entry point.

Equivalent capability to the reference's pydcop/dcop_cli.py: global
options (-v verbosity, --timeout with a forced-exit slack timer,
--output, --version, --log) and the subcommands ported so far (solve,
batch, serve).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading

#: extra seconds after --timeout before the process force-exits
#: (reference: dcop_cli.py TIMEOUT_SLACK = 40)
TIMEOUT_SLACK = 40


def make_parser() -> argparse.ArgumentParser:
    from pydcop_tpu_torch.version import __version__

    parser = argparse.ArgumentParser(
        prog="pydcop_tpu_torch",
        description="DCOP solving on NVIDIA GPUs with PyTorch and CUDA "
        "(pyDCOP capability set)",
    )
    parser.add_argument("-v", "--verbosity", type=int, default=0,
                        choices=[0, 1, 2, 3])
    parser.add_argument("--version", action="version",
                        version=f"pydcop_tpu_torch {__version__}")
    parser.add_argument("-t", "--timeout", type=float, default=None,
                        help="global timeout in seconds")
    parser.add_argument("--strict_timeout", type=float, default=None,
                        help="hard wall-clock limit (forced exit)")
    parser.add_argument("-o", "--output", default=None,
                        help="result output file")
    parser.add_argument("--log", default=None,
                        help="logging fileConfig")

    subparsers = parser.add_subparsers(dest="command", required=True)
    from pydcop_tpu_torch.commands import batch, serve, solve

    for module in (solve, batch, serve):
        module.set_parser(subparsers)
    return parser


def _setup_logging(verbosity: int, log_conf) -> None:
    if log_conf:
        from logging import config as logging_config

        logging_config.fileConfig(log_conf)
        return
    levels = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO,
              3: logging.DEBUG}
    logging.basicConfig(
        level=levels.get(verbosity, logging.ERROR),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def main(argv=None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    _setup_logging(args.verbosity, args.log)

    # forced-exit watchdog: even if a solver wedges, the CLI returns
    hard_limit = args.strict_timeout or (
        args.timeout + TIMEOUT_SLACK if args.timeout else None
    )
    if hard_limit:
        def force_exit():
            print('{"status": "STOPPED", "reason": "forced timeout"}',
                  file=sys.stderr)
            os._exit(42)

        watchdog = threading.Timer(hard_limit, force_exit)
        watchdog.daemon = True
        watchdog.start()

    from pydcop_tpu_torch.errors import NotPortedError

    try:
        return args.func(args) or 0
    except NotPortedError as e:
        # an option the port refuses before it solves: a clean error
        print(json.dumps({"status": "ERROR", "error": str(e)}))
        return 1
    except KeyboardInterrupt:
        print('{"status": "STOPPED"}', file=sys.stderr)
        return 130


if __name__ == "__main__":
    sys.exit(main())
