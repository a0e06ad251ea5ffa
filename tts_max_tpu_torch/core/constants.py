"""Token-vocabulary and codec constants for the SpeechLM TTS pipeline.

Copy of ``tts_max_tpu/core/constants.py`` (the port imports nothing of the
JAX package): speech-token templates, special markers, codec rates, nonverbal
vocabulary, and reward-function names.
"""

# --- training ---------------------------------------------------------------
LOSS_IGNORE_TOKEN_ID = -100

# --- speech token templates -------------------------------------------------
# Speech tokens are "<|s_N|>" for N in [0, codebook_size).
SPEECH_TOKEN_TEMPLATE = "<|s_{}|>"

# Special structural markers added to the tokenizer (reference constants.py:6-13).
SPEECH_START_TOKEN = "<|speech_start|>"
SPEECH_END_TOKEN = "<|speech_end|>"
TEXT_PROMPT_START_TOKEN = "<|text_prompt_start|>"
TEXT_PROMPT_END_TOKEN = "<|text_prompt_end|>"
VOICE_DESCRIPTION_START_TOKEN = "<|voice_description_start|>"
VOICE_DESCRIPTION_END_TOKEN = "<|voice_description_end|>"
SOUND_EFFECT_START_TOKEN = "<|sound_effect_start|>"
SOUND_EFFECT_END_TOKEN = "<|sound_effect_end|>"
END_HEADER_ID = "<|end_header_id|>"

SPECIAL_TOKENS = [
    SPEECH_START_TOKEN,
    SPEECH_END_TOKEN,
    TEXT_PROMPT_START_TOKEN,
    TEXT_PROMPT_END_TOKEN,
    VOICE_DESCRIPTION_START_TOKEN,
    VOICE_DESCRIPTION_END_TOKEN,
    SOUND_EFFECT_START_TOKEN,
    SOUND_EFFECT_END_TOKEN,
]

# Template used to pad the vocabulary up to the fixed size.
EXTRA_TOKEN_TEMPLATE = "<|extra_token_{}|>"

# Fixed final tokenizer vocabulary size (reference tokenization.py:8).
FIXED_VOCAB_SIZE = 193856

# --- codec rates ------------------------------------------------------------
# 50 discrete codes per second of audio at 16 kHz (reference constants.py:20-21).
CODEC_TOKEN_RATE = 50
CODEC_SAMPLE_RATE = 16000
# hop length in samples: 16000 / 50 (reference encoder.py:13-14).
CODEC_HOP_LENGTH = 320
# FSQ codebook: levels [4]*8 -> 4**8 entries.
CODEBOOK_SIZE = 65536
FSQ_LEVELS = (4, 4, 4, 4, 4, 4, 4, 4)

# --- file names / splits ----------------------------------------------------
CONFIG_FILE_NAME = "training_config.json"
TRAIN_SPLIT = "train"
VAL_SPLIT = "val"

# --- task prompt (reference constants.py:28) --------------------------------
DEFAULT_MODEL_INSTRUCTION = "Convert the text to speech:"

# --- metrics ----------------------------------------------------------------
TOTAL_SOURCE = "total"

# --- reward function names (reference constants.py:34-36) -------------------
WER_REWARD_FUNC = "WERRewardFunc"
DNSMOS_REWARD_FUNC = "DNSMOSRewardFunc"
SIMILARITY_REWARD_FUNC = "SimilarityRewardFunc"

# --- 21 nonverbal tokens (reference constants.py:39-61) ---------------------
NONVERBAL_TOKENS = [
    "<breathe>",
    "<burp>",
    "<chew>",
    "<clear_throat>",
    "<cough>",
    "<cry>",
    "<gasp>",
    "<grunt>",
    "<hiccup>",
    "<laugh>",
    "<moan>",
    "<pant>",
    "<scream>",
    "<sigh>",
    "<sing>",
    "<slurp>",
    "<sneeze>",
    "<sniff>",
    "<snort>",
    "<whistle>",
    "<yawn>",
]
