"""Logging setup: one format on the console and in the run's ``out.log``.

The port of the JAX package's ``train/logger.py``. The handlers it installs
replace those of an earlier call in the same process (a test or a second
run), so a run never writes into another run's log file.
"""

import logging

_HANDLERS = []


def setup_logging(log_file, level, include_host: bool = False):
    host = ""
    if include_host:
        import socket

        host = f" {socket.gethostname()} |"
    formatter = logging.Formatter(f"%(asctime)s |{host} %(levelname)s | %(message)s",
                                  datefmt="%Y-%m-%d,%H:%M:%S")
    logging.root.setLevel(level)
    # only this package's loggers: setting every registered logger makes
    # third-party exit-time logging write into closed streams
    for name in logging.root.manager.loggerDict:
        if name.startswith("refining_clip"):
            logging.getLogger(name).setLevel(level)
    while _HANDLERS:
        handler = _HANDLERS.pop()
        logging.root.removeHandler(handler)
        handler.close()
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(filename=log_file))
    for handler in handlers:
        handler.setFormatter(formatter)
        logging.root.addHandler(handler)
        _HANDLERS.append(handler)
