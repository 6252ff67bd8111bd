"""Observation operators of the port."""

from .gp import (GPBankOperator, GPParams, fit_gp, gp_predict_pixel, load_gp,
                 save_gp, stack_gp_bank)
from .gp_import import (gp_params_from_emulator, load_emulator_bank_file,
                        load_emulator_directory, load_emulator_pickle)
from .identity import IdentityOperator
from .joint import ProsailJointOperator, WCMJointOperator, joint_state_bounds
from .kernels import (KernelsAux, KernelsOperator, li_sparse_reciprocal,
                      ross_li_kernels, ross_thick)
from .mlp import MLPOperator, fit_mlp, mlp_apply
from .prosail import ProsailAux, ProsailOperator
from .protocol import BandView, MappedStateModel, ObservationModel
from .twostream import (NIR_MAPPER, VIS_MAPPER, TwoStreamOperator,
                        tlai_to_lai, twostream_albedo)
from .wcm import (WCM_PARAMETERS, WCMAux, WCMOperator, validate_state,
                  wcm_sigma0)

__all__ = [
    "BandView", "GPBankOperator", "GPParams", "IdentityOperator",
    "KernelsAux", "KernelsOperator", "MLPOperator", "MappedStateModel",
    "NIR_MAPPER", "ObservationModel", "ProsailAux", "ProsailJointOperator",
    "ProsailOperator", "TwoStreamOperator", "VIS_MAPPER", "WCMAux",
    "WCMJointOperator", "WCMOperator", "WCM_PARAMETERS", "fit_gp",
    "fit_mlp", "gp_params_from_emulator", "gp_predict_pixel",
    "joint_state_bounds", "li_sparse_reciprocal", "load_emulator_bank_file",
    "load_emulator_directory", "load_emulator_pickle", "load_gp",
    "mlp_apply", "ross_li_kernels", "ross_thick", "save_gp", "stack_gp_bank", "tlai_to_lai", "twostream_albedo", "validate_state",
    "wcm_sigma0",
]
