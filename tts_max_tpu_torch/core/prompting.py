"""Prompt compilation for training and inference.

Copy of ``tts_max_tpu/core/prompting.py`` (the port imports nothing of the
JAX package). A training sample is the user message, a newline, and the
closed assistant message ``<|speech_start|>`` + speech tokens +
``<|speech_end|>``. The inference prompt concatenates the audio-prompt
transcript with the text to synthesize, and leaves the assistant message
open after ``<|speech_start|>`` followed by the prompt's speech tokens.
"""

from __future__ import annotations

from collections.abc import Sequence

from tts_max_tpu_torch.core import constants


def format_transcript(transcript: str) -> str:
    return (
        f"{constants.TEXT_PROMPT_START_TOKEN}{transcript}"
        f"{constants.TEXT_PROMPT_END_TOKEN}"
    )


def format_voice_description(voice_description: str) -> str:
    return (
        f"{constants.VOICE_DESCRIPTION_START_TOKEN}{voice_description}"
        f"{constants.VOICE_DESCRIPTION_END_TOKEN}"
    )


def format_speech_tokens(speech_ids: Sequence[int]) -> str:
    return "".join(constants.SPEECH_TOKEN_TEMPLATE.format(i) for i in speech_ids)


def _user_message_body(transcript_block: str, voice_description: str) -> str:
    if voice_description:
        return (
            "Given the following voice description "
            + format_voice_description(voice_description)
            + " convert the text to speech:"
            + transcript_block
        )
    return constants.DEFAULT_MODEL_INSTRUCTION + transcript_block


def compile_inference_prompt(
    audio_prompt_transcription: str,
    text_to_synthesize: str,
    speech_ids: Sequence[int],
    voice_description: str = "",
    enable_instruction: bool = True,
) -> str:
    """Open-ended generation prompt (reference InferencePromptCompiler)."""
    if audio_prompt_transcription and (not voice_description or enable_instruction):
        transcript = f"{audio_prompt_transcription} {text_to_synthesize}"
    else:
        transcript = text_to_synthesize
    user = _user_message_body(format_transcript(transcript), voice_description)
    assistant = constants.SPEECH_START_TOKEN + format_speech_tokens(speech_ids)
    return user + "\n" + assistant


def compile_training_prompt(
    transcript: str,
    speech_ids: Sequence[int],
    voice_description: str = "",
) -> str:
    """Full training example: user message + "\\n" + closed assistant message."""
    if len(speech_ids) == 0:
        raise ValueError("Speech IDs are empty!")
    user = _user_message_body(format_transcript(transcript), voice_description)
    assistant = (
        constants.SPEECH_START_TOKEN
        + format_speech_tokens(speech_ids)
        + constants.SPEECH_END_TOKEN
    )
    return user + "\n" + assistant
