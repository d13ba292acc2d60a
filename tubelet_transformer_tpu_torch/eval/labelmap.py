"""AVA pbtxt label-map parsing (reference utils/utils.py:10-25 semantics)."""

from __future__ import annotations

from typing import Dict, List, Set, Tuple


def read_labelmap(path: str) -> Tuple[List[Dict], Set[int]]:
    """Parse an AVA-style pbtxt: items with ``name: "..."`` and ``id: N``.

    Returns (categories [{'id', 'name'}...], whitelist ids set).
    """
    categories = []
    class_ids: Set[int] = set()
    name = ""
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("name:"):
                name = s.split('"')[1]
            elif s.startswith(("id:", "label_id:")):
                cid = int(s.split(":")[1].strip())
                class_ids.add(cid)
                categories.append({"id": cid, "name": name})
    return categories, class_ids
