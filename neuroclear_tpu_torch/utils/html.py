"""Plain-string HTML report writer, a copy of ``neuroclear_tpu/utils/html.py``
(the same strings, so both packages write the same pages)."""

from __future__ import annotations

import os


class HTML:
    def __init__(self, web_dir, title, refresh=0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.refresh = refresh
        self.body: list[str] = []

    def get_image_dir(self):
        return self.img_dir

    def add_header(self, text):
        self.body.append(f"<h3>{text}</h3>")

    def add_images(self, ims, txts, links, width=400):
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='word-wrap:break-word' halign='center' valign='top'>"
                f"<p><a href='{link}'><img style='width:{width}px' src='{im}'></a><br>"
                f"{txt}</p></td>")
        self.body.append(
            "<table border='1' style='table-layout:fixed'><tr>"
            + "".join(cells) + "</tr></table>")

    def save(self, filename: str = "index.html"):
        refresh = (f"<meta http-equiv='refresh' content='{self.refresh}'>"
                   if self.refresh > 0 else "")
        html = (f"<!DOCTYPE html><html><head><title>{self.title}</title>{refresh}"
                f"</head><body><h1>{self.title}</h1>"
                + "".join(self.body) + "</body></html>")
        with open(os.path.join(self.web_dir, filename), "wt") as f:
            f.write(html)
