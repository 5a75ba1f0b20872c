"""Physical constants and unit conversions.

The reference code (derekeverett/iS3D, src/cpp/iS3D.h:9-17) works in a mixed
GeV/fm unit system: energies in GeV, lengths/times in fm, converted through
hbar*c.  We keep the same conventions so that file-format parity is exact.
"""

import math

# hbar * c in GeV fm (reference: src/cpp/iS3D.h:9)
HBARC = 0.197327053

# 2 pi^2 (hbar c)^3 -- normalization of thermal momentum integrals
# (reference: src/cpp/iS3D.h two_pi2_hbarC3)
TWO_PI2_HBARC3 = 2.0 * math.pi**2 * HBARC**3

# (2 pi hbar c)^-3 -- Cooper-Frye prefactor
# (reference: src/cpp/emissionfunction_smooth_kernels.cpp:36)
CF_PREFACTOR = (2.0 * math.pi * HBARC) ** -3

# capacity limits mirrored from the reference data model
# (reference: src/cpp/iS3D.h:14-17)
MAX_PARTICLE = 600
MAX_DECAY_CHANNEL = 50
MAX_DECAY_PART = 5
