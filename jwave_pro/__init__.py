"""jwave_pro — a wavelet transform framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
Prophetizo/JWave-Pro (pure-Java reference, see SURVEY.md): FWT (1D/2D/3D),
Wavelet Packet Transform with best-basis selection, shift-invariant MODWT,
complex CWT scalograms, FFT utilities, 67 discrete + 5 continuous wavelets,
compression/denoising post-processing, streaming, and multi-chip sharding via
``jax.sharding`` meshes.

Everything is a pure function over ``(batch..., N)`` arrays; transforms jit,
vmap, grad and shard.  Wavelet filter banks are host-side float64 constants.
"""

from .wavelets import (
    DiscreteWavelet, biorthogonal, coiflet, daubechies, good_wavelets,
    legendre, qmf_biorthogonal, qmf_orthonormal, symlet, wavelet,
    wavelet_names,
)
from .ops import (  # noqa: F401
    MAX_DECOMPOSITION_LEVEL, analysis_step, basis_coefficients,
    basis_coefficients2, basis_reconstruct, basis_reconstruct2, best_basis,
    best_basis2, wpt2_tree,
    circular_convolve, circular_convolve_adjoint, decompose, fwt, fwt2, fwt3,
    ifwt, ifwt2, ifwt3, imodwt, iwpt, iwpt2, iwpt3, log_energy_cost, modwt,
    imodwt2, imodwt3, imodwpt, modwt2, modwt2_mra, modwt3, modwt3_mra,
    modwpt, modwpt_basis_reconstruct, modwpt_best_basis, modwpt_mra,
    modwpt_node_path, modwpt_tree, imodwpt2, modwpt2, imodwpt3, modwpt3,
    modwpt2_basis_reconstruct, modwpt2_best_basis, modwpt2_tree,
    modwt_base_filters, modwt_mra, recompose, shannon_entropy_cost,
    synthesis_step, threshold_cost, wpt, wpt2, wpt3, wpt_tree,
)
from .utils import (  # noqa: F401
    ancient_egyptian_decomposition, is_power_of_two, max_level,
    next_power_of_two,
)
from .utils.deploy import export_pipeline, load_pipeline  # noqa: F401
from .ops.cwt import (  # noqa: F401
    CWTResult, cwt, cwt_direct, generate_linear_scales, generate_log_scales,
    icwt,
)
from .ops.cwt2d import CWT2Result, cwt2, icwt2  # noqa: F401
from .ops.ssq import SSQResult, issq_cwt, ssq_cwt  # noqa: F401
from .ops.ridge import RidgeResult, extract_ridges  # noqa: F401
from .ops.ewt import EWTResult, ewt1d, ewt_filter_bank, iewt1d  # noqa: F401
from .ops.mp import MPResult, matching_pursuit, mp_reconstruct  # noqa: F401
from .ops.dtcwt import (  # noqa: F401
    DTCWT2Result, DTCWTResult, dtcwt, dtcwt2, dtcwt2_denoise, dtcwt_denoise,
    idtcwt, idtcwt2, qshift_design, qshift_wavelets,
)
from .ops.scattering import (  # noqa: F401
    ScatteringResult, scattering1d, scattering_filters,
)
from .ops.scattering2d import (  # noqa: F401
    Scattering2DResult, scattering2d, scattering2d_filters,
)
from .ops.fft import fft, ifft  # noqa: F401
from .ops.analysis import (  # noqa: F401
    ChangePoints, VarianceCI, WTCResult, envelope, hilbert,
    instantaneous_frequency, modwt_changepoints,
    modwt_correlation, modwt_covariance, modwt_cross_correlation,
    modwt_hurst, modwt_variance, modwt_variance_ci, scale_energies,
    wavelet_coherence,
)
from .ops.lifting import cdf53, cdf97, icdf53, icdf97  # noqa: F401
from .ops.pywt_compat import (  # noqa: F401
    coeffs_to_flat, dwt, dwt2, dwt3, flat_to_coeffs, idwt, idwt2, idwt3,
    wavedec, wavedec2, wavedec3, waverec, waverec2, waverec3,
)
from .ops.arbitrary import (  # noqa: F401
    aed_forward, aed_inverse, swt_forward, swt_inverse,
)
from .ops.compress import (  # noqa: F401
    compress_fixed, compress_magnitude, compress_peaks_average,
    compression_rate,
)
from .ops.financial import (  # noqa: F401
    cumulate_returns, ewma_volatility, fill_gaps, log_returns,
    median_select, normalize_volatility, preprocess_prices,
    realized_volatility, winsorize_outliers,
)
from .ops.denoise import (  # noqa: F401
    bayes_threshold, hard_threshold, mad_sigma, modwt2_denoise,
    modwt3_denoise, modwt_denoise, modwt_denoise_inplace, soft_threshold,
    sure_threshold, wpt2_denoise, wpt_denoise,
    universal_threshold,
)
from .wavelets.continuous import (  # noqa: F401
    ContinuousWavelet, DOGWavelet, MexicanHatWavelet, MeyerWavelet,
    MorletWavelet, PaulWavelet, continuous_wavelet,
)
from .wavelets.continuous2d import (  # noqa: F401
    ContinuousWavelet2D, MexicanHat2D, Morlet2D, continuous_wavelet2d,
)
from .transforms import (  # noqa: F401
    AncientEgyptianDecomposition, ContinuousWaveletTransform,
    DiscreteFourierTransform, FastFourierTransform, FastWaveletTransform,
    MODWTTransform, ShiftingWaveletTransform, Transform,
    WaveletPacketTransform, build_transform,
)
from . import streaming  # noqa: F401  (jw.streaming.streaming_transform)

__version__ = "0.1.0"
