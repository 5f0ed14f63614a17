"""Shared constants of the world-model stack (copy of gtax/core/constants.py;
the port imports nothing from gtax)."""

# VAE latent scaling factor applied after encode / removed before decode
# (4/51, the reference's 0.07843137255).
LATENT_SCALE = 0.07843137255

# Diffusion discretisation: number of absolute noise levels.
MAX_NOISE_LEVEL = 1000

# Latent geometry of the flagship pipeline: 360x640 RGB -> patch 20 ->
# 18x32 tokens with 16 channels.
FRAME_HEIGHT = 360
FRAME_WIDTH = 640
LATENT_CHANNELS = 16
LATENT_HEIGHT = 18
LATENT_WIDTH = 32

# Sliding temporal context of the DiT.
MAX_FRAMES = 5

# Action conditioning: 25-way one-hot keyboard action per frame; index 3 is
# "W" / drive forward.
ACTION_DIM = 25
ACTION_FORWARD_INDEX = 3

# Latent-noise clamp used during training and rollout.
NOISE_ABS_MAX = 20.0
