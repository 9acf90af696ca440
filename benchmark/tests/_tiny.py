"""A cell at a size a CPU test run holds: the configuration's networks at
their published widths on 48x80 frames, a pool of three short videos."""

from __future__ import annotations

import copy

from benchmark.core.spec import BENCH, Cell, read_json


def tiny_cell(name: str = "stcn-480p.session60", lengths=(9, 7, 8),
              per_video: int = 4) -> Cell:
    bench = read_json(BENCH.parent / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = read_json(BENCH.parent / entry["file"])
    cfg["frame"] = [48, 80]
    tr = copy.deepcopy(read_json(BENCH / "traffic" / f"{w['traffic']}.json"))
    tr["videos"]["lengths"] = list(lengths)
    tr["interactions"]["per_video"] = min(per_video, tr["interactions"]["per_video"])
    tr["warmup"]["lengths"] = [6]
    tr["check"]["among_first"] = min(3, tr["check"]["among_first"])
    tr["check"]["visits"] = min(2, tr["check"]["visits"])
    return Cell(w, cfg, tr, read_json(BENCH / "limits" / f"{name}.json"),
                bench["end_to_end"], bench["per_layer"])


# SAM at a size a CPU run holds, keeping the 256-wide embedding the agent
# reads (the program's "vit_h" preset is pointed at it for the test)
TINY_SAM = dict(img_size=128, encoder_embed_dim=32, encoder_depth=2,
                encoder_num_heads=2, encoder_global_attn_indexes=[1],
                window_size=4, decoder_mlp_dim=64, mask_in_chans=4)


def tiny_eva_cell(monkeypatch) -> Cell:
    from eva_vos_tpu_torch.models.sam import build as sam_build

    monkeypatch.setitem(sam_build.PRESETS, "vit_h", sam_build.SamConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_SAM.items()}))
    bench = read_json(BENCH.parent / "BENCHMARK.json")
    name = "eva-vos.session60"     # a cell not yet in BENCHMARK.json
    w = {"name": name, "config": "eva-vos-vith", "traffic": "eva-vos60", "chips": 1}
    cfg = read_json(BENCH / "configs" / "eva-vos-vith.json")
    cfg["frame"] = [48, 80]
    cfg["sam"].update(TINY_SAM)
    tr = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    tr["videos"]["lengths"] = [12, 10]
    tr["warmup"] = {"lengths": [8], "rounds": 3}
    return Cell(w, cfg, tr, read_json(BENCH / "limits" / f"{name}.json"),
                bench["end_to_end"], bench["per_layer"])
