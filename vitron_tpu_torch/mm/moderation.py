"""Text moderation hook (reference: vitron/utils.py:117-135).

Port of `vitron_tpu/mm/moderation.py`, whose code it keeps as it is. The
reference POSTs the user prompt to OpenAI's moderation endpoint and fails
OPEN (returns not-flagged) on any error. Same semantics here, with the
transport injectable so serving deployments can point at their own
moderation service and tests never touch the network. Disabled (always
not-flagged) unless OPENAI_API_KEY is set — which also matches how the
upstream app behaves without the key.
"""
from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, Optional

MODERATION_URL = "https://api.openai.com/v1/moderations"


def _http_post(url: str, data: bytes, headers: dict, timeout: float) -> dict:
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def violates_moderation(text: str,
                        post: Optional[Callable[..., dict]] = None,
                        url: str = MODERATION_URL,
                        timeout: float = 5.0) -> bool:
    """True if the moderation service flags `text`; False on any failure
    (fail-open, identical to the reference's except branches)."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key and post is None:
        return False
    headers = {"Content-Type": "application/json",
               "Authorization": "Bearer " + (api_key or "")}
    payload = json.dumps({"input": text.replace("\n", "")}).encode("utf-8")
    try:
        ret = (post or _http_post)(url, payload, headers, timeout)
        return bool(ret["results"][0]["flagged"])
    except Exception:
        return False
