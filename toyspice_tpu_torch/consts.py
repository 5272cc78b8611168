"""Physical constants.

SPICE2-era values (not CODATA), matching the reference
internal/consts/consts.go:3-7 so device equations agree to the last bit.
"""

CHARGE = 1.6021918e-19  # Elementary charge (C)
BOLTZMANN = 1.3806226e-23  # Boltzmann constant (J/K)
KELVIN = 273.15  # 0 degC in Kelvin (K)

# Default analysis temperature, 27 degC (reference hardcodes 300.15 at
# pkg/analysis/op.go:41, tran.go:108, dc.go:116 and device Tnom fields).
TEMP_DEFAULT = 300.15

# Vacuum permeability (H/m), reference pkg/device/magnetic.go:11.
import math as _math

MU0 = 4 * _math.pi * 1e-7
