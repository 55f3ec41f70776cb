# Global constants shared by every layer of the framework (the port's own
# copy of ctrlhair_tpu/constants.py).
#
# Mirrors the semantic constants of the reference implementation
# (the reference's global_value_utils.py:13-56) — the 19-class CelebAMask-HQ
# label taxonomy, hair/hat indices and visualisation colour tables — but is
# otherwise an independent design.

import numpy as np

# CelebAMask-HQ label order used across the whole pipeline.
PARSING_LABEL_LIST = [
    'background', 'skin_other', 'nose', 'eye_g', 'l_eye', 'r_eye', 'l_brow',
    'r_brow', 'l_ear', 'r_ear', 'mouth', 'u_lip', 'l_lip', 'hair', 'hat',
    'ear_r', 'neck_l', 'neck', 'cloth',
]
NUM_CLASSES = len(PARSING_LABEL_LIST)  # 19
HAIR_IDX = PARSING_LABEL_LIST.index('hair')  # 13
HAT_IDX = PARSING_LABEL_LIST.index('hat')  # 14
BACKGROUND_IDX = PARSING_LABEL_LIST.index('background')  # 0
UNKNOWN_LABEL = 255

# The face-parsing network (BiSeNet) emits classes in its own order
# (ref: external_code/face_parsing/my_parsing_util.py:19-22).  This table maps
# a BiSeNet class id -> CelebAMask class id, applied as a static gather.
_BISENET_LABEL_LIST = [
    'background', 'skin_other', 'l_brow', 'r_brow', 'l_eye', 'r_eye', 'eye_g',
    'l_ear', 'r_ear', 'ear_r', 'nose', 'mouth', 'u_lip', 'l_lip', 'neck',
    'neck_l', 'cloth', 'hair', 'hat',
]
BISENET_TO_CELEBA = np.array(
    [PARSING_LABEL_LIST.index(name) for name in _BISENET_LABEL_LIST],
    dtype=np.int32,
)

# Inverse permutation: CELEBA_TO_BISENET[celeba_id] = bisenet_id.  Permuting
# the LOGIT channels with this before argmax yields CelebA ids directly —
# a free layout op instead of a [N,512,512] gather after argmax (the remap
# is a bijection, so argmax commutes with it).
CELEBA_TO_BISENET = np.argsort(BISENET_TO_CELEBA).astype(np.int32)

# Visualisation colours (one per class), used by mask_to_rgb.
PARSING_COLOR_LIST = np.array([
    [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [51, 255, 255], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0], [255, 85, 255],
    [255, 170, 255], [0, 170, 255], [85, 255, 255], [170, 255, 255],
    [255, 255, 255],
], dtype=np.uint8)

MASK_VIS_COLOR = np.array([
    [0, 128, 64], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [51, 255, 255], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
], dtype=np.uint8)

# Canonical pipeline resolutions.
EDIT_SIZE = 256      # edit pipeline operates at 256x256 (ref: hair_editor.py:50)
PARSE_SIZE = 512     # BiSeNet runs at 512x512 (ref: my_parsing_util.py:34)
CROP_SIZE = 1024     # shape-transfer crop resolution (ref: mask_adaptor.py:189)

STYLE_DIM = 512      # SEAN per-region style-code width
SHAPE_DIM = 16       # shape (mask VAE) latent width
FACE_DIM = 1024      # face context latent width
TEXTURE_DIM = 8      # texture latent width
CURLINESS_DIM = 1    # curliness latent width
