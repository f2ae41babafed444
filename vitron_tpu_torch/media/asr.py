"""Audio decode for audio-referred segmentation (host side).

Port of the decode half of `vitron_tpu/media/asr.py` (:24-76): a PCM WAV
through the stdlib `wave` module (8-bit unsigned, 16- and 32-bit signed,
any channel count, averaged to mono), then soundfile, then ffmpeg for other
containers, and a linear resample to the recognizer's rate. The audio never
reaches the device: only a transcript enters SEEM. The Whisper recognizer
(`WhisperASR`, `default_asr`) needs weights that the repository lacks and
stays out; `VitronSystem.asr` is the hook a recognizer is installed on.
"""
from __future__ import annotations

import numpy as np

WHISPER_SR = 16000


def _load_wav_stdlib(path: str):
    """PCM WAV via the stdlib -> (mono float32 in [-1, 1), the file's rate)."""
    import wave

    with wave.open(path, "rb") as f:
        n, ch, width, file_sr = (f.getnframes(), f.getnchannels(), f.getsampwidth(),
                                 f.getframerate())
        raw = f.readframes(n)
    if width == 2:
        wav = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        wav = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:  # unsigned 8-bit
        wav = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        wav = wav.reshape(-1, ch).mean(axis=1)
    return wav, file_sr


def load_audio(path: str, sr: int = WHISPER_SR) -> np.ndarray:
    """Decode an audio file to mono float32 at `sr` Hz: the stdlib WAV
    reader, else soundfile, else ffmpeg (which resamples itself)."""
    import wave

    try:
        wav, file_sr = _load_wav_stdlib(path)
    except (wave.Error, EOFError, ValueError):  # not a PCM WAV the stdlib reads
        try:
            import soundfile as sf

            data, file_sr = sf.read(path, dtype="float32", always_2d=True)
            wav = data.mean(axis=1)
        except (ImportError, RuntimeError):  # no soundfile, or it cannot read the container
            import subprocess

            out = subprocess.run(["ffmpeg", "-nostdin", "-i", path, "-f", "f32le", "-ac", "1",
                                  "-ar", str(sr), "-"], capture_output=True, check=True)
            return np.frombuffer(out.stdout, np.float32)
    if file_sr != sr:
        n = int(round(len(wav) * sr / file_sr))
        wav = np.interp(np.linspace(0.0, len(wav) - 1.0, n), np.arange(len(wav)),
                        wav).astype(np.float32)
    return wav
