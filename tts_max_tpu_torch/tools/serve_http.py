"""HTTP TTS serving (counterpart of ``tools/serve_http.py``).

Stdlib only (``http.server`` + threading): a background worker thread drives
the port's continuous-batching engine; HTTP handlers submit requests and
block on a per-request event. Endpoints:

  POST /synthesize   {"text": ..., "prompt_wav"?: path, "prompt_transcript"?,
                      "voice_description"?, "language"?, "max_tokens"?,
                      "min_tokens"?, "temperature"?, "top_k"?, "top_p"?,
                      "repetition_penalty"?, "frequency_penalty"?, "seed"?}
                     -> audio/wav bytes (16 kHz int16 mono)
  POST /generate     same body -> {"tokens": [...], "codes": [...],
                      "finish_reason": ...} (no vocoding)
  POST /stream       same body (+ chunk_codes?, context_codes?) ->
                      chunked-transfer audio/wav, emitted while generating
                      (``inference/streaming.StreamingDecoder``)
  GET  /stats        -> engine stats JSON (slots, queue, tokens; blocks and
                      prefix-cache hits with the paged engine)
  GET  /health       -> {"ok": true}

Runs on the card unless ``--device cpu`` is given:

  python -m tts_max_tpu_torch.tools.serve_http --model_dir serving --port 8400 \\
      [--host 127.0.0.1] [the engine flags of serve_batch, without
      --no_prefix_cache] [--codec_decoder dec.pt --codec_encoder enc.pt] \\
      [--quantize [int8|int4|int4-g64|int4-g128]] [--dtype bfloat16] [--device cuda]

``--quantize`` and pre-quantized dirs as in ``serving_inference``; the
engine flags, ``--prefill_ahead`` and ``--park_*`` among them, as in
``serve_batch``. Not taken (it fails in argparse): ``--no_staged_cache``, as
in ``serve_batch``.
"""

from __future__ import annotations

import argparse
import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tts_max_tpu_torch.core import prompting
from tts_max_tpu_torch.core.constants import CODEC_SAMPLE_RATE, CODEC_TOKEN_RATE
from tts_max_tpu_torch.core.tokenization import build_byte_tokenizer, speech_vocab
from tts_max_tpu_torch.data import normalization
from tts_max_tpu_torch.data.audio_io import load_wav
from tts_max_tpu_torch.inference.streaming import StreamingDecoder
from tts_max_tpu_torch.ops.sampling import SamplingParams, sampling_from_overrides
from tts_max_tpu_torch.tools.serve_batch import add_engine_args, build_engine
from tts_max_tpu_torch.tools.serving_inference import add_model_args, build_codec, load_model
from tts_max_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("serve_http")


def _fmt(sample_rate: int) -> bytes:
    return b"WAVEfmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)


def pcm_bytes(wav: np.ndarray) -> bytes:
    """Mono 16-bit little-endian PCM of a float wav clipped to [-1, 1]."""
    return (np.clip(np.asarray(wav, np.float32).ravel(), -1, 1) * 32767.0).astype("<i2").tobytes()


def wav_bytes(wav: np.ndarray, sample_rate: int = CODEC_SAMPLE_RATE) -> bytes:
    """A mono 16-bit PCM WAV file in memory (no scipy at request time)."""
    pcm = pcm_bytes(wav)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + _fmt(sample_rate)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def wav_stream_header(sample_rate: int = CODEC_SAMPLE_RATE) -> bytes:
    """WAV header for a stream of unknown length (RIFF and data sizes
    maxed: the convention players read as 'until EOF')."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + _fmt(sample_rate)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


class _StreamSub:
    """Per-request token subscription filled by the engine worker thread:
    lists of new tokens, then None when the request finished."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.consumed = 0  # tokens already pushed


class TtsServer:
    """Engine + worker thread + synchronous request API."""

    def __init__(self, engine, tokenizer, sv, encoder, decoder, default_max_tokens: int,
                 max_len: int, normalizer=None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.sv = sv
        self.encoder = encoder
        self.decoder = decoder
        self.normalizer = normalizer or normalization.create()
        self.default_max_tokens = default_max_tokens
        self.max_len = max_len
        self._lock = threading.Lock()
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, object] = {}
        self._token_subs: dict[int, _StreamSub] = {}
        self._seed = 0
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while not self._stop:
            try:
                with self._lock:
                    work = self.engine.has_work()
                    # poll() pipelines K-step dispatches; submissions
                    # interleave between polls
                    done = self.engine.poll() if work else []
            except Exception as exc:  # keep serving; fail what was waiting
                log.exception("engine step failed; failing the requests in flight")
                self._fail_pending(exc)
                time.sleep(0.1)
                continue
            with self._lock:
                # push newly generated tokens to /stream subscribers
                for slot in self.engine._slots:
                    req = slot.request
                    sub = self._token_subs.get(req.request_id) if req is not None else None
                    if sub is not None and len(slot.generated) > sub.consumed:
                        sub.q.put(list(slot.generated[sub.consumed:]))
                        sub.consumed = len(slot.generated)
                for c in done:
                    sub = self._token_subs.get(c.request_id)
                    if sub is not None:
                        toks = np.asarray(c.tokens).tolist()
                        if len(toks) > sub.consumed:
                            sub.q.put(toks[sub.consumed:])
                            sub.consumed = len(toks)
                        sub.q.put(None)  # finished
                    ev = self._events.pop(c.request_id, None)
                    if ev:  # nobody waits after a timeout or cancel: drop the result
                        self._results[c.request_id] = c
                        ev.set()
            if not work:
                time.sleep(0.005)

    def _fail_pending(self, exc: Exception) -> None:
        """After a failed engine step: every waiting request gets the error
        (``request`` raises it) and every stream ends."""
        with self._lock:
            for rid, ev in list(self._events.items()):
                self.engine.cancel(rid)
                self._results[rid] = exc
                ev.set()
            self._events.clear()
            for rid, sub in self._token_subs.items():
                self.engine.cancel(rid)
                sub.q.put(None)

    def shutdown(self):
        self._stop = True
        self._worker.join(timeout=5)

    def _prepare(self, body: dict):
        """Compile the prompt; returns (input_ids, budget, sampling,
        prompt_speech_ids). Raises ValueError on bad input."""
        speech_ids: list[int] = []
        if body.get("prompt_wav"):
            wav, _ = load_wav(body["prompt_wav"], CODEC_SAMPLE_RATE)
            speech_ids = np.asarray(self.encoder.encode(body["prompt_wav"], wav)).ravel().tolist()
        # route by the request's language tag, or by detection
        text = self.normalizer.normalize(body["text"], body.get("language") or None)
        prompt = prompting.compile_inference_prompt(
            body.get("prompt_transcript", ""), text, speech_ids,
            body.get("voice_description", ""), True)
        input_ids = np.asarray(self.tokenizer.encode(prompt, add_special_tokens=True),
                               dtype=np.int32)
        budget = min(int(body.get("max_tokens", self.default_max_tokens)),
                     self.max_len - len(input_ids))
        if budget <= 0:
            raise ValueError(f"prompt is {len(input_ids)} tokens; no budget within "
                             f"max_len {self.max_len}")
        return input_ids, budget, sampling_from_overrides(body, SamplingParams()), speech_ids

    def _submit(self, body: dict, input_ids, budget, sampling) -> int:
        """Under the lock: submit with the body's seed or the next one."""
        self._seed += 1
        return self.engine.submit(
            input_ids, budget, eos_id=self.sv.speech_end_id,
            sampling_seed=int(body.get("seed", self._seed)), sampling=sampling,
            min_tokens=int(body.get("min_tokens", 0)))

    def request(self, body: dict, timeout: float = 600.0):
        """Returns (completion, prompt_speech_ids). Raises on bad input, on a
        timeout and when the engine failed."""
        input_ids, budget, sampling, speech_ids = self._prepare(body)
        ev = threading.Event()
        with self._lock:
            rid = self._submit(body, input_ids, budget, sampling)
            self._events[rid] = ev
        if not ev.wait(timeout):
            # free the slot and make sure no result leaks
            with self._lock:
                self.engine.cancel(rid)
                self._events.pop(rid, None)
                self._results.pop(rid, None)
            raise TimeoutError("generation timed out")
        result = self._results.pop(rid)
        if isinstance(result, Exception):
            raise RuntimeError(f"engine failed: {result}") from result
        return result, speech_ids

    def request_stream(self, body: dict):
        """Submit and subscribe: returns (rid, token subscription,
        prompt_speech_ids). The worker thread pushes token deltas to the
        subscription as each dispatch's blob lands; the caller must
        ``finish_stream(rid)`` when done (success, error or disconnect)."""
        input_ids, budget, sampling, speech_ids = self._prepare(body)
        sub = _StreamSub()
        with self._lock:
            rid = self._submit(body, input_ids, budget, sampling)
            self._token_subs[rid] = sub
        return rid, sub, speech_ids

    def finish_stream(self, rid: int) -> None:
        with self._lock:
            self._token_subs.pop(rid, None)
            self.engine.cancel(rid)  # a no-op if already finished

    def stats(self) -> dict:
        # host-side counters, read without the lock so that observability
        # never queues behind a dispatch in flight
        return self.engine.stats()


def make_handler(server: TtsServer):
    class Handler(BaseHTTPRequestHandler):
        # /stream uses chunked transfer encoding, which HTTP/1.0 does not
        # define; every other response sends Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            log.info("%s " + fmt, self.client_address[0], *a)

        def _json(self, code: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"ok": True})
            if self.path == "/stats":
                return self._json(200, server.stats())
            return self._json(404, {"error": "unknown endpoint"})

        def _stream(self, body: dict):
            """POST /stream: chunked-transfer WAV, emitted while the SpeechLM
            generates; ``chunk_codes`` / ``context_codes`` set the
            StreamingDecoder's granularity."""
            rid, sub, prompt_ids = server.request_stream(body)
            sd = StreamingDecoder(server.decoder, int(body.get("chunk_codes", 25)),
                                  int(body.get("context_codes", 50)),
                                  history=prompt_ids if prompt_ids else None)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def wchunk(b: bytes):
                if b:
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

            try:
                wchunk(wav_stream_header())
                while True:
                    try:
                        toks = sub.q.get(timeout=600.0)
                    except queue.Empty:
                        break  # generation stalled: close the stream
                    if toks is None:  # finished
                        wchunk(pcm_bytes(sd.flush()))
                        break
                    codes = server.sv.codes_from_tokens(np.asarray(toks, dtype=np.int64))
                    if len(codes):
                        wchunk(pcm_bytes(sd.push(codes)))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; finish_stream frees the slot
            except Exception:
                # headers are already sent: a second response would corrupt
                # the framing mid-body, so log and close the connection
                log.exception("stream failed mid-body; closing connection")
                self.close_connection = True
            finally:
                server.finish_stream(rid)

        def do_POST(self):
            try:
                if self.path not in ("/generate", "/synthesize", "/stream"):
                    return self._json(404, {"error": "unknown endpoint"})
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if "text" not in body:
                    return self._json(400, {"error": "missing 'text'"})
                if self.path == "/stream":
                    return self._stream(body)
                comp, prompt_ids = server.request(body)
                codes = server.sv.codes_from_tokens(np.asarray(comp.tokens))
                if self.path == "/generate":
                    return self._json(200, {"tokens": np.asarray(comp.tokens).tolist(),
                                            "codes": codes.tolist(),
                                            "finish_reason": comp.finish_reason})
                all_codes = np.concatenate([np.asarray(prompt_ids, dtype=np.int64), codes])
                if len(all_codes) == 0:
                    return self._json(422, {"error": "no speech tokens"})
                wav = server.decoder.decode(all_codes)
                skip = int(len(prompt_ids) / CODEC_TOKEN_RATE * CODEC_SAMPLE_RATE)
                data = wav_bytes(wav[:, skip:])
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except (ValueError, KeyError) as e:
                return self._json(400, {"error": str(e)})
            except TimeoutError as e:
                return self._json(504, {"error": str(e)})
            except Exception as e:  # keep serving on unexpected errors
                log.exception("request failed")
                return self._json(500, {"error": str(e)})

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(allow_abbrev=False)
    add_model_args(parser)
    add_engine_args(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400)
    return parser.parse_args(argv)


def build_server(args) -> TtsServer:
    """Load the model and codec, build and warm up the engine, start the
    worker thread."""
    tokenizer = build_byte_tokenizer()
    sv = speech_vocab(tokenizer)
    params, cfg, _ = load_model(args)
    encoder, decoder = build_codec(args)
    # the paged engine always caches prefixes here, as in the JAX server
    engine = build_engine(args, params, cfg, sv, prefix_cache=True)
    return TtsServer(engine, tokenizer, sv, encoder, decoder, args.max_tokens, args.max_len)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(0)
    server = build_server(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    log.info("Serving TTS on http://%s:%d", args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
