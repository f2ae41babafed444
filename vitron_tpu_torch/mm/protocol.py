"""Structured-output protocol: parse `<module>/<instruction>/<region>` tags.

The MLLM emits a structured text protocol naming a backend module and the
instructions/regions to forward to it. This parser preserves the reference
semantics bit-for-bit (reference: app.py:345-408). The port's own copy of
`vitron_tpu/mm/protocol.py`.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

# Backend task routing letters (reference: app.py:400-408)
TASK_IMAGE_GENERATION = "A"
TASK_IMAGE_SEGMENTATION = "B"
TASK_IMAGE_EDITING = "C"
TASK_VIDEO_GENERATION = "D"
TASK_VIDEO_TRACKING = "E"
TASK_VIDEO_EDITING = "F"
TASK_IMAGE_TO_VIDEO = "G"

TASK_NAMES = {
    TASK_IMAGE_GENERATION: "image_generation",
    TASK_IMAGE_SEGMENTATION: "image_segmentation",
    TASK_IMAGE_EDITING: "image_editing",
    TASK_VIDEO_GENERATION: "video_generation",
    TASK_VIDEO_TRACKING: "video_tracking",
    TASK_VIDEO_EDITING: "video_editing",
    TASK_IMAGE_TO_VIDEO: "image_to_video",
}


def find_module_content(data: str) -> Optional[str]:
    """First `<module>...</module>` payload (reference: app.py:345-351)."""
    match = re.search(r"<module>(.*?)</module>", data)
    return match.group(1) if match else None


def find_instruction_content(data: str) -> Optional[List[str]]:
    """All `<instruction>...</instruction>` payloads, keeping only the text
    after the last ':' in each (reference: app.py:354-364)."""
    match = re.findall(r"<instruction>(.*?)</instruction>", data)
    if match:
        return [m.split(":")[-1].strip() for m in match]
    return None


def find_region_instruction_content(data: str) -> Optional[str]:
    """First `<region>...</region>` payload (reference: app.py:367-372)."""
    match = re.search(r"<region>(.*?)</region>", data)
    return match.group(1) if match else None


def remove_special_tags(text: str) -> str:
    """Strip all `<tag>...</tag>` spans (reference: app.py:376-381)."""
    return re.sub(r"<[^>]+>(.*?)<[^>]+>", "", text)


def parse_model_output(
    model_output: str,
) -> Tuple[str, Optional[str], Optional[List[str]], Optional[str]]:
    """Parse a raw model response into (clean_text, module, instructions, region).

    Reference: app.py:384-395.
    """
    module = find_module_content(model_output)
    instruction = find_instruction_content(model_output)
    region = find_region_instruction_content(model_output)
    output = remove_special_tags(model_output)
    return output, module, instruction, region
