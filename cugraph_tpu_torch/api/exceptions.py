"""Exception surface mirroring pylibcugraph/exceptions.py in the reference."""


class CugraphTpuError(Exception):
    """Base class for framework errors (reference: cugraph_error_code_t,
    cpp/include/cugraph_c/error.h)."""


class FailedToConvergeError(CugraphTpuError):
    """Raised when an iterative algorithm hits max_iterations without
    converging (reference: python/pylibcugraph/pylibcugraph/exceptions.py)."""


class InvalidInputError(CugraphTpuError, ValueError):
    """Bad user input (reference: CUGRAPH_EXPECTS / cugraph_error_code_t)."""
