"""Status codes and exceptions (GSL's ``err/gsl_errno.h:40-50``).

Two calling conventions mirror GSL's ``_e`` / non-``_e`` split
(``interp.c:131-151``): batched device code returns a status tensor beside
its results, and host-facing wrappers raise :class:`GslError` subclasses
(:func:`strict_check` is the one host read between the two).
"""

from __future__ import annotations

# Status codes (values match err/gsl_errno.h).
SUCCESS = 0
FAILURE = -1
EDOM = 1      # input domain error
ERANGE = 2    # output range error
EINVAL = 4    # invalid argument
ESING = 21    # apparent singularity
ETABLE = 23   # table limit exceeded (capacity overflow here)


class GslError(Exception):
    """Base for all library errors (GSL_ERROR analog)."""

    code = FAILURE


class DomainError(GslError):
    """Input outside the valid domain (GSL_EDOM)."""

    code = EDOM


class InvalidArgumentError(GslError):
    """Invalid argument supplied (GSL_EINVAL)."""

    code = EINVAL


class SingularError(GslError):
    """Apparent singularity detected (GSL_ESING)."""

    code = ESING


class CapacityError(GslError):
    """Fixed-capacity buffer exhausted (GSL_ETABLE analog)."""

    code = ETABLE


_CODE_TO_EXC = {
    EDOM: DomainError,
    EINVAL: InvalidArgumentError,
    ESING: SingularError,
    ETABLE: CapacityError,
}


def check_status(status: int, msg: str = "") -> None:
    """Raise the exception matching a status code."""
    status = int(status)
    if status == SUCCESS:
        return
    raise _CODE_TO_EXC.get(status, GslError)(msg or f"status={status}")


def strict_check(ok, exc: type[GslError], msg: str) -> None:
    """Raise ``exc`` if any entry of ``ok`` (a bool tensor) is False.

    One host read of ``ok.all()``.  The JAX package's version skips the
    check under tracing; PyTorch runs eagerly, so it always checks.
    """
    if not bool(ok.all()):
        raise exc(msg)
