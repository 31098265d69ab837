"""Integrity check / bot score: scoring of the browser-fingerprint payload.

Reference behavior (Go banjax): internal/integrity_check.go — the client
JS on the challenge page stores a base64 JSON payload of 17 fingerprint
fields in the `deflect_integrity` cookie; the server decodes it and computes
a weighted 9-factor score normalized to [0,1] (webdriver=10, gpu_renderer=7,
no_plugins=3, zero_lang=3, low_cpu=2, low_memory=2, fullscreen=2,
color_depth=1, small_screen=1). A missing or invalid payload scores 1.0.
The sha256 fingerprint hash is over a fixed '|'-joined field string.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Tuple

from banjax_tpu_torch.crypto._b64 import decode_strict_b64

INTEGRITY_CHECK_COOKIE_NAME = "deflect_integrity"


def _json_field(d: Dict[str, Any], key: str, typ: type) -> Any:
    """Go encoding/json field semantics: absent or null → None (zero value
    kept by the caller); wrong JSON type → error. bool is not an int here,
    and a JSON float never unmarshals into a Go int field."""
    v = d.get(key)
    if v is None:
        return None
    if typ is int:
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"field {key}: cannot unmarshal {type(v).__name__} into int")
        return v
    if typ is bool and not isinstance(v, bool):
        raise ValueError(f"field {key}: cannot unmarshal {type(v).__name__} into bool")
    if not isinstance(v, typ):
        raise ValueError(f"field {key}: cannot unmarshal {type(v).__name__} into {typ.__name__}")
    return v

_FACTOR_WEIGHTS = {
    "webdriver": 10,
    "no_plugins": 3,
    "gpu_renderer": 7,
    "low_cpu": 2,
    "low_memory": 2,
    "color_depth": 1,
    "zero_lang": 3,
    "fullscreen": 2,
    "small_screen": 1,
}
_MAX_SCORE = sum(_FACTOR_WEIGHTS.values())

_SOFTWARE_RENDERERS = ("swiftshader", "llvmpipe", "mesa")


@dataclasses.dataclass
class IntegrityCheckPayload:
    """integrity_check.go:24-42; field names match the JSON keys."""

    webdriver: bool = False
    has_plugins: bool = False
    gpu_renderer: str = ""
    cpu: int = 0
    memory: int = 0
    screen_width: int = 0
    screen_height: int = 0
    window_inner_width: int = 0
    window_inner_height: int = 0
    color_depth: int = 0
    lang_length: int = 0
    language: str = ""
    languages: List[str] = dataclasses.field(default_factory=list)
    timezone: str = ""
    platform: str = ""
    canvas_fp: str = ""
    webgl_fp: str = ""
    math_fp: str = ""
    webcam: bool = False

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "webdriver": self.webdriver,
            "hasPlugins": self.has_plugins,
            "gpuRenderer": self.gpu_renderer,
            "cpu": self.cpu,
            "memory": self.memory,
            "screen": {"width": self.screen_width, "height": self.screen_height},
            "window": {"innerWidth": self.window_inner_width, "innerHeight": self.window_inner_height},
            "colorDepth": self.color_depth,
            "langLength": self.lang_length,
            "language": self.language,
            "languages": list(self.languages),
            "timezone": self.timezone,
            "platform": self.platform,
            "canvasFp": self.canvas_fp,
            "webglFp": self.webgl_fp,
            "mathFp": self.math_fp,
            "webcam": self.webcam,
        }

    @classmethod
    def from_json_dict(cls, d: Any) -> "IntegrityCheckPayload":
        """Strict decode matching Go encoding/json semantics: a JSON null
        (whole document or any field) is a no-op keeping the zero value; a
        type mismatch (string-into-bool, float-into-int, ...) is an error."""
        if d is None:
            return cls()
        if not isinstance(d, dict):
            raise ValueError("integrity payload must be a JSON object")
        screen = _json_field(d, "screen", dict) or {}
        window = _json_field(d, "window", dict) or {}
        languages_raw = _json_field(d, "languages", list) or []
        languages = []
        for x in languages_raw:
            if x is None:
                languages.append("")  # Go: null element → zero string
            elif isinstance(x, str):
                languages.append(x)
            else:
                raise ValueError("languages must be strings")
        return cls(
            webdriver=_json_field(d, "webdriver", bool) or False,
            has_plugins=_json_field(d, "hasPlugins", bool) or False,
            gpu_renderer=_json_field(d, "gpuRenderer", str) or "",
            cpu=_json_field(d, "cpu", int) or 0,
            memory=_json_field(d, "memory", int) or 0,
            screen_width=_json_field(screen, "width", int) or 0,
            screen_height=_json_field(screen, "height", int) or 0,
            window_inner_width=_json_field(window, "innerWidth", int) or 0,
            window_inner_height=_json_field(window, "innerHeight", int) or 0,
            color_depth=_json_field(d, "colorDepth", int) or 0,
            lang_length=_json_field(d, "langLength", int) or 0,
            language=_json_field(d, "language", str) or "",
            languages=languages,
            timezone=_json_field(d, "timezone", str) or "",
            platform=_json_field(d, "platform", str) or "",
            canvas_fp=_json_field(d, "canvasFp", str) or "",
            webgl_fp=_json_field(d, "webglFp", str) or "",
            math_fp=_json_field(d, "mathFp", str) or "",
            webcam=_json_field(d, "webcam", bool) or False,
        )


@dataclasses.dataclass
class IntegrityCheckPayloadWrapper:
    payload: IntegrityCheckPayload = dataclasses.field(default_factory=IntegrityCheckPayload)
    hash: str = ""


def _go_bool(b: bool) -> str:
    return "true" if b else "false"


def calc_fingerprint(p: IntegrityCheckPayload) -> str:
    """integrity_check.go:49-74 — sha256 over a '|'-joined field string.

    The Go format string ends with %t booleans; reproduce "true"/"false".
    """
    languages = ",".join(p.languages)
    raw = (
        f"{p.platform}|{p.timezone}|{p.language}|{languages}|{p.cpu}|{p.memory}|"
        f"{p.color_depth}|{p.lang_length}|{p.screen_width}x{p.screen_height}|"
        f"{p.gpu_renderer}|{p.canvas_fp}|{p.webgl_fp}|{p.math_fp}|"
        f"{_go_bool(p.webdriver)}|{_go_bool(p.has_plugins)}|{_go_bool(p.webcam)}"
    )
    return hashlib.sha256(raw.encode()).hexdigest()


def calc_bot_score(
    p: IntegrityCheckPayload,
) -> Tuple[float, str, IntegrityCheckPayloadWrapper]:
    """integrity_check.go:77-177 — returns (normalized score, top factor, wrapper)."""
    score = 0
    factor_scores: Dict[str, int] = {}

    def add(factor: str) -> None:
        nonlocal score
        score += _FACTOR_WEIGHTS[factor]
        factor_scores[factor] = _FACTOR_WEIGHTS[factor]

    if p.webdriver:
        add("webdriver")
    if not p.has_plugins:
        add("no_plugins")
    gpu_lower = p.gpu_renderer.lower()
    if any(s in gpu_lower for s in _SOFTWARE_RENDERERS):
        add("gpu_renderer")
    if p.cpu <= 2:
        add("low_cpu")
    if p.memory <= 2:
        add("low_memory")
    if p.color_depth < 24:
        add("color_depth")
    if p.lang_length == 0:
        add("zero_lang")
    if p.screen_width == p.window_inner_width and p.screen_height == p.window_inner_height:
        add("fullscreen")
    if p.screen_width < 1000 or p.screen_height < 700:
        add("small_screen")

    top_factor = ""
    top_score = 0
    for k, v in factor_scores.items():
        if v > top_score:
            top_score = v
            top_factor = k

    normalized = min(score / _MAX_SCORE, 1.0)
    return normalized, top_factor, IntegrityCheckPayloadWrapper(p, calc_fingerprint(p))


def calc_bot_score_from_cookie(
    base64_payload: str,
) -> Tuple[float, str, IntegrityCheckPayloadWrapper]:
    """integrity_check.go:179-197 — empty/invalid payloads score 1.0."""
    if not base64_payload:
        return 1.0, "no_payload", IntegrityCheckPayloadWrapper()
    try:
        decoded = decode_strict_b64(base64_payload)
        payload = IntegrityCheckPayload.from_json_dict(json.loads(decoded))
    except (ValueError, TypeError, AttributeError, json.JSONDecodeError):
        return 1.0, "err_payload", IntegrityCheckPayloadWrapper()
    return calc_bot_score(payload)
