"""AES-SpMM core: adaptive edge sampling, quantization, graph containers."""
from repro_torch.core.aes_spmm import aes_spmm, sample
from repro_torch.core.graph import (CSR, ELL, apply_csr_deltas,
                                    csr_from_edges, ell_live_widths,
                                    gcn_normalize, mean_normalize)
from repro_torch.core.quantization import (QuantizedFeatures, dequantize,
                                           quantize, requantize_rows)
from repro_torch.core.sampling import (PRIME_NUM, SampleStrategy,
                                       get_sample_strategy, hash_start_ind,
                                       sample_csr_to_ell,
                                       sample_csr_to_ell_afs,
                                       sample_csr_to_ell_sfs, sampling_rate)

__all__ = [
    "aes_spmm", "sample", "CSR", "ELL", "apply_csr_deltas", "csr_from_edges",
    "ell_live_widths", "gcn_normalize", "mean_normalize", "QuantizedFeatures",
    "dequantize", "quantize", "requantize_rows", "PRIME_NUM",
    "SampleStrategy", "get_sample_strategy", "hash_start_ind",
    "sample_csr_to_ell", "sample_csr_to_ell_afs", "sample_csr_to_ell_sfs",
    "sampling_rate",
]
