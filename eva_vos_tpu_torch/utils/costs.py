"""Simulated human annotation time model, in seconds (a copy of
``eva_vos_tpu/utils/costs.py``; the reference's ``util/helpers.py:50-58``).
These constants are the x-axis of every result curve.
"""

ANNOTATION_COSTS = {
    "no_object": 3,
    "mask": 80,
    "click": 1.5,
    "3clicks": 3 * 1.5,
    "bbox": 7,
    "click_overhead": 1,
    "stop": 0,
}
