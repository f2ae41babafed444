"""Speech to text for audio-referred segmentation.

Port of `vitron_tpu/media/asr.py`. The decode (:24-76): a PCM WAV through
the stdlib `wave` module (8-bit unsigned, 16- and 32-bit signed, any
channel count, averaged to mono), then soundfile, then ffmpeg for other
containers, and a linear resample to the recognizer's rate. The recognizer
(:79-132): `WhisperASR`, a Whisper checkpoint through `transformers`,
imported and loaded on the first `transcribe` and run on `device` (default
`cuda`); a hub id resolves only from files already on the machine
(`local_files_only=True`: nothing is fetched). `default_asr` gives one when
`VITRON_WHISPER` names a checkpoint, else None, and `VitronSystem` installs
it as its `asr` hook, as the JAX system does. Only a transcript enters SEEM.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

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


class WhisperASR:
    """A Whisper recognizer whose `transcribe` gives the reference's
    whisper result surface ({"text": str}). `model` is a local checkpoint
    dir or a hub id already in the local cache. Construction loads nothing,
    so a server can always install the hook and fail with the loader's
    message only when audio arrives."""

    def __init__(self, model: str = "openai/whisper-base", device="cuda"):
        self.model_id = model
        self.device = device
        self._pipe = None

    def _load(self):
        if self._pipe is None:
            from transformers import WhisperForConditionalGeneration, WhisperProcessor

            proc = WhisperProcessor.from_pretrained(self.model_id, local_files_only=True)
            mdl = WhisperForConditionalGeneration.from_pretrained(
                self.model_id, local_files_only=True).to(self.device).eval()
            self._pipe = (proc, mdl)
        return self._pipe

    def transcribe(self, audio) -> dict:
        """audio: a file path or a float32 waveform at 16 kHz -> {"text": str}."""
        import torch

        if isinstance(audio, (str, os.PathLike)):
            audio = load_audio(str(audio))
        proc, mdl = self._load()
        feats = proc(audio, sampling_rate=WHISPER_SR, return_tensors="pt").input_features
        with torch.no_grad():
            ids = mdl.generate(feats.to(self.device), max_new_tokens=128)
        return {"text": proc.batch_decode(ids, skip_special_tokens=True)[0].strip()}


def default_asr(device="cuda") -> Optional[WhisperASR]:
    """The serving layer's hook: a WhisperASR on `device` when
    `VITRON_WHISPER` names a checkpoint, else None (upstream ships its
    whisper load disabled, demo_code/app.py:76-77)."""
    model = os.environ.get("VITRON_WHISPER")
    return WhisperASR(model, device=device) if model else None


Transcriber = Callable[[object], dict]
