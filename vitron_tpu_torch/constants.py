"""Model-wide constants.

The port's own copy of `vitron_tpu/constants.py`, a rebuild of the
reference constant set
(reference: vitron/constants.py:1-35). Sentinel token ids are negative so
they can never collide with real vocabulary ids; the multimodal splice
(vitron_tpu_torch/mm/splice.py) replaces them with media feature sequences.
"""

# Loss masking
IGNORE_INDEX = -100

# Sentinel token ids spliced into the token stream by the tokenizer helpers
# (reference: vitron/constants.py:9,24)
IMAGE_TOKEN_INDEX = -200
OBJS_TOKEN_INDEX = -300

# Default special token strings (reference: vitron/constants.py:10-29)
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"
VIDEO_PLACEHOLDER = "<video-placeholder>"

DEFAULT_OBJS_TOKEN = "<objs>"
DEFAULT_OBJS_START_TOKEN = "<objs_start>"
DEFAULT_OBJS_END_TOKEN = "<objs_end>"
OBJS_PLACEHOLDER = "<objs-placeholder>"

# Media budget clamps (reference: vitron/constants.py:32-35)
MAX_IMAGE_LENGTH = 16
MAX_VIDEO_LENGTH = 1
PAD_LENGTH = 620

# Vision defaults shared across towers / preprocessing
# (reference: vitron/mm_utils.py:12-13)
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

# ViT-L/14 geometry at 224x224: 16x16 = 256 patch tokens per image
# (reference: vitron/model/multimodal_encoder/clip_encoder.py:78)
VISION_IMAGE_SIZE = 224
VISION_PATCH_SIZE = 14
IMAGE_FEATURE_LENGTH = (VISION_IMAGE_SIZE // VISION_PATCH_SIZE) ** 2  # 256
NUM_VIDEO_FRAMES = 8  # uniform temporal sampling (processing_video.py:93)
VIDEO_FEATURE_LENGTH = NUM_VIDEO_FRAMES * IMAGE_FEATURE_LENGTH  # 2048
REGION_FEATURE_LENGTH = 1  # region extractor emits [B, 1, H] (layer.py:130)
