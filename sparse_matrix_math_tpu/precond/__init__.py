from .preconditioners import (
    FactorizationError,
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
    SolverPreconditioner,
    get_preconditioner,
)
from .cheby_poly import ChebyshevPreconditioner
from .trisolve import TriangularMatrix, triangular_from_csr_arrays
