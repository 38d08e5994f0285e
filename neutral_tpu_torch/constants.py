"""Physical and numerical constants for the neutral-particle transport framework.

A copy of `neutral_tpu/constants.py`: the port imports nothing from
`neutral_tpu`, whose package import pulls in JAX.

These mirror the problem-independent constants of the reference mini-app
(the reference's neutral_data.h:17-27) so that validation against the
shipped golden tallies is meaningful.  The values themselves are public
physical constants plus the reference's dummy material parameters.
"""

# 1 eV in Joules
EV_TO_J = 1.60217646e-19

# Avogadro's constant [1/mol]
AVOGADROS = 6.02214085774e23

# One barn in m^2
BARNS = 1.0e-28

# Neutron mass [kg]
PARTICLE_MASS = 1.674927471213e-27

# Mass number of the (dummy) target nuclide
MASS_NO = 1.0e2

# Dummy molar mass [kg/mol]
MOLAR_MASS = 1.0e-2

# Particles whose energy drops below this (eV) are culled at the next
# absorption event.
MIN_ENERGY_OF_INTEREST = 1.0e0

# The left/bottom domain bounds are open; movement to those facets
# overshoots the edge by this amount so the particle provably changes cell.
OPEN_BOUND_CORRECTION = 1.0e-13

# Relative tolerance for end-to-end tally validation.
VALIDATE_TOLERANCE = 1.0e-3

# Number of uniform variates produced per counter-based RNG call.
NRANDOM_NUMBERS = 2

# Default cross-section table assets (regenerated, not copied — see xs.py).
CS_SCATTER_FILENAME = "elastic_scatter.cs"
CS_CAPTURE_FILENAME = "capture.cs"
