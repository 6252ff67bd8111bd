"""Seeded bare-except violations plus every accepted escape hatch."""

import logging

LOG = logging.getLogger(__name__)


def swallow_exception(fn):
    try:
        fn()
    except Exception:  # expect: bare-except
        pass


def swallow_everything(fn):
    result = None
    try:
        result = fn()
    except:  # expect: bare-except
        result = -1
    return result


def swallow_base(fn):
    try:
        fn()
    except BaseException:  # expect: bare-except
        pass


def justified(fn):
    try:
        fn()
    except Exception:  # best-effort cache warm; the cold path is correct
        pass


def logged(fn):
    try:
        fn()
    except Exception as exc:
        LOG.warning("fn failed: %s", exc)


def reraised(fn):
    try:
        fn()
    except Exception:
        raise


def narrowed(fn):
    try:
        fn()
    except (OSError, ValueError):
        pass
