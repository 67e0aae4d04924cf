"""Reconstruction I/O (`theia/io/`).

Counterpart of the JAX package's `io/`: readers and writers for the native
checkpoint (versioned npz), JSON, PLY, COLMAP, Bundler, NVM, Strecha,
1DSfM, NeRFStudio / SDFStudio, calibration priors, and the reference's
cereal `.recon` archives (`io/theia_recon.py`). All host-side numpy; the
files each package writes, the other reads.
"""

from .recon import (  # noqa: F401
    read_reconstruction,
    write_reconstruction,
    write_reconstruction_json,
)
from .ply import write_ply_file  # noqa: F401
from .colmap import write_colmap_files  # noqa: F401
from .bundler import read_bundler_files, write_bundler_files  # noqa: F401
from .nvm import export_nvm_file, import_nvm_file  # noqa: F401
from .strecha import read_strecha_dataset  # noqa: F401
from .onedsfm import read_1dsfm  # noqa: F401
from .nerfstudio import write_nerfstudio_files, write_sdfstudio_files  # noqa: F401
from .calibration import read_calibration, write_calibration  # noqa: F401
