from .csr import CSRMatrix, csr_from_coo, csr_from_dense, csr_from_triplet
from .dia import DIAMatrix, dia_from_csr, try_dia_from_csr
from .ell import ELLMatrix, ell_from_csr
from .hyb import HYBMatrix, hyb_from_csr
from .stencil import GridStencilMatrix, try_grid_stencil_from_csr
from .reorder import (
    ReorderedMatrix,
    permute_csr,
    rcm_permutation,
    reorder_rcm,
)
from .triplet import COOArrays, TripletMatrix, coo_from_arrays


def best_format(csr):
    """Pick the operator layout for a CSR matrix's pattern.

    1. Grid stencil — constant-coefficient tensor-product-grid operators
       (Poisson/convection-diffusion class, verified entry-for-entry):
       matrix-free, zero matrix traffic (formats/stencil.py);
    2. DIA — diagonal-structured patterns: gather-free shifted slices;
    3. CSR itself — every other pattern.

    The returned object plugs into every solver/``rmult`` call site.
    """
    dia = try_dia_from_csr(csr)
    if dia is None:
        return csr
    st = try_grid_stencil_from_csr(csr, dia=dia)
    return st if st is not None else dia
