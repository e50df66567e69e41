"""Render an HTML report from closed-loop eval JSONs (+ optional videos).

(reference: scripts/publish_closed_loop_eval.py) Port of
``nvblox_mindmap_tpu/scripts/publish_closed_loop_eval.py``::

    python -m nvblox_mindmap_torch.scripts.publish_closed_loop_eval \\
        --eval_files eval.json --output report/index.html [--video_dir videos/]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List


def render_report(eval_paths: List[str], output_path: str, video_dir=None):
    rows = []
    for path in sorted(eval_paths):
        with open(path) as f:
            summary = json.load(f)
        rows.append((os.path.basename(path), summary))

    html = ["<html><head><title>Closed-loop evaluation</title>",
            "<style>table{border-collapse:collapse}td,th{border:1px solid #999;"
            "padding:4px 8px}</style></head><body>",
            "<h1>Closed-loop evaluation</h1><table>",
            "<tr><th>run</th><th>demos</th><th>successes</th>"
            "<th>success rate</th></tr>"]
    for name, summary in rows:
        html.append(
            f"<tr><td>{name}</td><td>{summary.get('num_demos', '?')}</td>"
            f"<td>{summary.get('num_successes', '?')}</td>"
            f"<td>{summary.get('success_rate', 0):.2%}</td></tr>"
        )
    html.append("</table>")
    for name, summary in rows:
        html.append(f"<h2>{name}</h2><ul>")
        for demo, ok in summary.get("outcomes", {}).items():
            html.append(
                f"<li>{demo}: {'&#9989; success' if ok else '&#10060; failure'}</li>"
            )
        html.append("</ul>")
    if video_dir:
        for video in sorted(glob.glob(os.path.join(video_dir, "*.mp4"))):
            rel = os.path.relpath(video, os.path.dirname(output_path) or ".")
            html.append(
                f"<h3>{os.path.basename(video)}</h3>"
                f'<video controls width="320" src="{rel}"></video>'
            )
    html.append("</body></html>")
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        f.write("\n".join(html))
    return output_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval_files", nargs="+", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--video_dir", default=None)
    args = parser.parse_args(argv)
    print(render_report(args.eval_files, args.output, args.video_dir))


if __name__ == "__main__":
    main()
