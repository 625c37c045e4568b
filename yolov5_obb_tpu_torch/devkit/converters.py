"""Format converters around the DOTA toolchain.

Copy of the JAX package's ``devkit/converters.py``: the val JSON → per-class
Task1 files (the reference's tools/TestJson2VocClassTxt.py), DOTA → COCO
json (DOTA_devkit/DOTA2COCO.py), DOTA → mmdet json (DOTA2JSON.py),
groundtruth → Task1 (dota_utils.groundtruth2Task1) and VOC XML → DOTA
(tools/Xml2Txt.py).  ``cv2`` only reads image sizes, imported inside the
two functions that need it.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..ops.geometry import poly2rbox


def json_to_task1(json_path, out_dir, classnames):
    """val.py --save-json output → per-class ``Task1_<name>.txt`` files.

    Rows: ``{image_id} {score} {poly}`` — the devkit merge input format."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dets = json.loads(Path(json_path).read_text())
    per_class = defaultdict(list)
    for d in dets:
        cid = int(d["category_id"])
        if cid >= len(classnames):
            continue
        poly = " ".join(f"{float(v):.1f}" for v in d["poly"])
        per_class[cid].append(f"{d['image_id']} {d['score']:.5f} {poly}")
    for i, name in enumerate(classnames):
        (out / f"Task1_{name}.txt").write_text(
            "\n".join(per_class.get(i, [])) + ("\n" if per_class.get(i) else "")
        )
    return out


def groundtruth_to_task1(anno_dir, out_dir, classnames, skip_difficult2=False):
    """DOTA labelTxt dir → per-class Task1 files with score 1.0
    (reference dota_utils.groundtruth2Task1:154-176)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    per_class = defaultdict(list)
    for f in sorted(Path(anno_dir).glob("*.txt")):
        stem = f.stem
        for line in f.read_text().splitlines():
            parts = line.split()
            if len(parts) < 9 or parts[8] not in classnames:
                continue
            if skip_difficult2 and len(parts) > 9 and parts[9] == "2":
                continue
            poly = " ".join(parts[:8])
            per_class[parts[8]].append(f"{stem} 1.0 {poly}")
    for name in classnames:
        (out / f"Task1_{name}.txt").write_text(
            "\n".join(per_class.get(name, [])) + ("\n" if per_class.get(name) else "")
        )
    return out


def dota_to_coco(split_dir, out_json, classnames, difficult_ok=("0", "1")):
    """DOTA split dir (images/ + labelTxt/) → COCO detection json
    (reference DOTA2COCO.py:21-120; hbb covers of the polys)."""
    import cv2

    split = Path(split_dir)
    images, annotations = [], []
    categories = [
        {"id": i + 1, "name": n, "supercategory": n} for i, n in enumerate(classnames)
    ]
    name_to_id = {n: i + 1 for i, n in enumerate(classnames)}
    ann_id = 1
    img_files = sorted((split / "images").glob("*"))
    for img_id, f in enumerate(img_files, start=1):
        img = cv2.imread(str(f))
        if img is None:
            continue
        h, w = img.shape[:2]
        images.append({"id": img_id, "file_name": f.name, "height": h, "width": w})
        lab = split / "labelTxt" / f"{f.stem}.txt"
        if not lab.exists():
            continue
        for line in lab.read_text().splitlines():
            parts = line.split()
            if len(parts) < 9 or parts[8] not in name_to_id:
                continue
            if len(parts) > 9 and parts[9] not in difficult_ok:
                continue
            poly = np.array([float(v) for v in parts[:8]])
            x, y = poly[0::2], poly[1::2]
            bw, bh = x.max() - x.min(), y.max() - y.min()
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": name_to_id[parts[8]],
                    "segmentation": [poly.tolist()],
                    "bbox": [float(x.min()), float(y.min()), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
    Path(out_json).parent.mkdir(parents=True, exist_ok=True)
    Path(out_json).write_text(
        json.dumps(
            {"images": images, "annotations": annotations, "categories": categories}
        )
    )
    return out_json


def dota_to_mmdet_json(split_dir, out_json, trainval=True):
    """DOTA split dir (images/ + labelTxt/) → mmdet-style per-image json list
    (reference DOTA2JSON.py:11-93).

    Each record: ``{filename, height, width, id, annotations: {bboxes, labels,
    bboxes_ignore, labels_ignore}}`` with rboxes as ``[cx cy l s theta]``
    (long-edge convention, θ∈[-π/2, π/2)); difficult==1 → ignore lists,
    difficult==2 dropped (matching the reference's parse_ann_info)."""
    import cv2

    split = Path(split_dir)
    records = []
    for img_id, f in enumerate(sorted((split / "images").glob("*"))):
        img = cv2.imread(str(f))
        if img is None:
            continue
        rec = {"filename": f.name, "height": int(img.shape[0]),
               "width": int(img.shape[1]), "id": img_id}
        lab = split / "labelTxt" / f"{f.stem}.txt"
        if trainval:
            if not lab.exists():
                continue
            ann = {"bboxes": [], "labels": [], "bboxes_ignore": [], "labels_ignore": []}
            for line in lab.read_text().splitlines():
                parts = line.split()
                if len(parts) < 9:
                    continue
                difficult = parts[9] if len(parts) > 9 else "0"
                if difficult == "2":
                    continue
                poly = np.array([[float(v) for v in parts[:8]]])
                rbox = poly2rbox(poly)[0].tolist()
                key = "" if difficult == "0" else "_ignore"
                ann["bboxes" + key].append([float(v) for v in rbox])
                ann["labels" + key].append(parts[8])
            rec["annotations"] = ann
        records.append(rec)
    Path(out_json).parent.mkdir(parents=True, exist_ok=True)
    Path(out_json).write_text(json.dumps(records))
    return out_json


def voc_xml_to_dota(xml_dir, out_dir, name_map=None):
    """DroneVehicle-style VOC XMLs (with polygon points) → DOTA labelTxt
    (reference tools/Xml2Txt.py:6-56)."""
    import xml.etree.ElementTree as ET

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for xml_f in sorted(Path(xml_dir).glob("*.xml")):
        rows = []
        root = ET.parse(xml_f).getroot()
        for obj in root.iter("object"):
            name = (obj.findtext("name") or "unknown").strip().replace(" ", "-")
            if name_map:
                name = name_map.get(name, name)
            diff = obj.findtext("difficult") or "0"
            pb = obj.find("polygon")
            if pb is None:  # Element truthiness is has-children, not existence
                pb = obj.find("point")
            if pb is not None:
                vals = [float(pb.findtext(f"{ax}{i}") or 0)
                        for i in range(1, 5) for ax in ("x", "y")]
            else:
                bb = obj.find("bndbox")
                if bb is None:
                    continue
                x1, y1 = float(bb.findtext("xmin")), float(bb.findtext("ymin"))
                x2, y2 = float(bb.findtext("xmax")), float(bb.findtext("ymax"))
                vals = [x1, y1, x2, y1, x2, y2, x1, y2]
            rows.append(" ".join(f"{v:.1f}" for v in vals) + f" {name} {diff}")
        (out / f"{xml_f.stem}.txt").write_text("\n".join(rows) + ("\n" if rows else ""))
        n += 1
    return out, n
