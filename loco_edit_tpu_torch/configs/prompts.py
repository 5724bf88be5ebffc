"""Canned prompt sets for the T2I engines (a copy of
loco_edit_tpu/configs/prompts.py).

The reference keeps per-experiment prompt dictionaries in
src/configs/prompts.py (consumed by the T-LOCO scripts); these are a small
representative set in the same shape. Users supply their own via
--for_prompt / --edit_prompt in practice.
"""

EDIT_PROMPTS = {
    "glasses": {
        "for_prompt": "A photo of a man",
        "edit_prompt": "A photo of a man wearing glasses",
    },
    "smile": {
        "for_prompt": "A photo of a woman",
        "edit_prompt": "A photo of a smiling woman",
    },
    "sunglasses-dog": {
        "for_prompt": "A photo of a dog",
        "edit_prompt": "A photo of a dog wearing sunglasses",
    },
    "church-autumn": {
        "for_prompt": "A photo of a church",
        "edit_prompt": "A photo of a church in autumn",
    },
}
