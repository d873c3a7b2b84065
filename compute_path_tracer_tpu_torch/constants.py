"""Global renderer constants (JAX package: ``constants.py``).

Mirrors the compile-time ``#define`` block of the reference compute kernel
(reference: assets/shaders/path_tracer/test_compute.glsl:26-39) and the
``MAXHIT`` sentinel emitted by the scene compiler
(reference: src/sdf_editor/sdf_editor.rs:193).
"""

import math

# Sphere-march budget (test_compute.glsl:26)
STEPS = 80

# Minimum hit distance - march terminates when |d| < MHD (test_compute.glsl:28)
MHD = 0.001

# Far plane - rays whose accumulated t exceeds this are misses (test_compute.glsl:29)
FP = 100.0

# Normal offset applied when respawning a bounced ray (test_compute.glsl:30)
OFFSET = 0.03

# Distance of the MAXHIT sentinel: empty scene / no-hit accumulator seed
# (sdf_editor.rs:193 `#define MAXHIT Hit(10000.0, MDEF)`)
MAX_DIST = 10000.0

PI = math.pi
PI2 = 2.0 * math.pi

# Default camera: eye position and the fov used as the z component of the
# un-normalized ray direction (test_compute.glsl:232-235, path_tracer.rs:162)
CAMERA_ORIGIN = (0.0, 0.0, -3.0)
DEFAULT_FOV = 1.0

# Settings slider ranges/defaults (path_tracer.rs:157-163)
DEFAULT_BOUNCES = 8
MAX_BOUNCES = 32

# Material slot count: col(3) + brightness + light(3) + spec + spec_col(3)
# + roughness + ior + refract_chance + refract_roughness + refract_col(3)
# (test_compute.glsl:45-59)
MAT_SIZE = 18

# Closed-form "no hit" distance, beyond any reachable march distance
# (JAX package: kernels/megakernel.py _BIG).
BIG = 4.0 * FP
