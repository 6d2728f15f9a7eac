"""small_fem_solver_tpu — offshore-jacket structural analysis in JAX.

A from-scratch JAX/XLA framework with the full capabilities of the
reference tool `JK-hqy/Small-FEM-Solver-based-on-a-lot-of-assumption`
(wave kinematics -> Morison loading -> 3D Timoshenko beam FEM -> stresses),
redesigned for an accelerator: batched XLA programs, vmapped phase scans
and design sweeps, block-sparse assembly and preconditioned-CG solves, and
`jax.sharding` device-mesh scaling.
"""

from .api import (AnalysisResults, CondensedPrepared, CondensedScanResults,
                  EnvelopeResults, LoadCase, analyze, analyze_condensed,
                  analyze_pdelta, analyze_pdelta_condensed,
                  analyze_phase_batch, analyze_ssi,
                  design_envelope, design_envelope_condensed,
                  analyze_prepared, phase_scan_condensed,
                  phase_scan_prepared, prepare_condensed,
                  scatter_fatigue, scatter_fatigue_spectral,
                  ScatterFatigueSpectral, LongTermExtremes,
                  long_term_extremes,
                  sea_response_batch, sea_scan_prepared,
                  spectral_response_prepared, spectral_transfer_prepared,
                  spectral_response_dynamic, spectral_transfer_dynamic,
                  FreqTransfer)
from .constants import (DEFAULT_E, DEFAULT_FY, DEFAULT_NU, DEFAULT_RHO_STEEL,
                        DEFAULT_RHO_WATER, G_GRAV)
from .models.model import (JacketModel, add_appurtenances, build_model,
                           refine_model)
from .models.presets import DEFAULT_STORM, default_3leg_jacket
from .ops.design import (SectionSensitivities, SizingResult,
                          optimize_sections, section_sensitivities)
from .ops.codecheck import CodeCheck, member_code_check
from .ops.codecheck_iso import ISOCheck, iso_member_check
from .ops.jointcheck import JointCheck, joint_code_check
from .ops.buckling import (BucklingResults, EulerScreen, buckling_analysis,
                           buckling_analysis_condensed, euler_member_screen)
from .ops.dynamics import (HarmonicResponse, ModalResults,
                           TransientResponse, dynamic_response,
                           dynamic_response_condensed, modal_analysis,
                           modal_analysis_condensed,
                           mac, transient_response_condensed)
from .ops.eigen import (eigh_general_small, jacobi_eigh, subspace_eigh,
                        subspace_largest)
from .ops.fatigue import FatigueScreen, fatigue_screen
from .ops.dispersion import apparent_period, solve_dispersion
from .ops.fenton import fenton_wave
from .ops.morison import MorisonLoads, morison_loads, phase_scan
from .ops.sections import TubeSections, tube_sections
from .ops.spectrum import (SpectralSea, make_random_sea, morison_sea_batch,
                           sea_kinematics, sea_surface,
                           spectral_fatigue_screen)
from .ops.airgap import AirGapResult, air_gap_check
from .ops.freqdomain import FreqDomainResponse
from .ops.metocean import (JointHsTp, fit_joint_hs_tp, fit_weibull,
                           iform_contour, n_year_sea_states,
                           return_period_beta, rosenblatt_hs_tp)
from .ops.reliability import (EnvironmentalReliability, FormResult,
                              MemberReliability, SystemReliability,
                              bivariate_normal_cdf, ditlevsen_bounds,
                              environmental_reliability, form,
                              hs_tp_limit_state, hs_tp_limit_state_batch,
                              importance_sample, importance_sample_batch,
                              member_reliability,
                              member_utilization_response_batch,
                              sorm_correction, utilization_response,
                              utilization_response_batch)
from .ops.pushover import PushoverResults, pushover, pushover_rose
from .ops.robustness import RemovalScreen, member_removal_screen
from .ops.seismic import (SpectrumResults, cqc_correlation, ec8_spectrum,
                          response_spectrum, response_spectrum_condensed,
                          table_spectrum)
from .ops.soil import (Pile, PileHeadStiffness, SoilLayer, axial_solve,
                       lateral_solve, pile_head_stiffness,
                       soil_support_stiffness)
from .ops.stokes import stokes_wave
from .ops.viv import VIVScreen, viv_screen
from .ops.wind import (wind_member_forces, wind_profile,
                       wind_topside_force)
from .ops.wave_models import make_wave, validate_wave
from .ops.waves import FourierWave, airy_wave, kinematics, surface_elevation
from .utils.combos import combine_results, combo_envelope
from .utils.persist import (design_envelope_resumable, load_results,
                            save_results)

__version__ = "0.1.0"
