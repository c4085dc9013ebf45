"""CLIP-guided training loss (port of seal3d_tpu/utils/clip_guidance.py):
renders under random poses are pulled toward a text prompt with loss =
-cos(CLIP(image), CLIP(text)), differentiable in the image; the CLIP
weights stay frozen.

The port's render is a torch graph already, so the trainer's `clip_step`
backpropagates this loss through the render into the field's params
directly: the JAX package's image-cotangent bridge has no counterpart.
`transformers` is imported only when a CLIPLoss is built with a model.

Construction modes, as in the JAX package:
  model_path   a local transformers CLIP checkpoint directory (nothing is
               downloaded);
  random_init  a small randomly initialised CLIPModel built from a config
               (no weights needed): the preprocessing, encode, loss and
               gradient all run, but the guidance direction is meaningless.
Without either, or where transformers does not import, `available` is
False. The features are the projected pooled outputs of CLIP's text and
vision towers, composed here as `get_text_features` /
`get_image_features` compose them in transformers 4.x (later versions
return a model output from those methods instead of the tensor).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# CLIP pixel normalization
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPLoss:
    def __init__(self, text: Optional[str] = None,
                 model_path: Optional[str] = None, random_init: bool = False,
                 device=None):
        self.available = False
        self.text = text
        self.text_feat = None
        self._tok = None
        self.device = torch.device(device if device is not None else "cpu")
        if model_path is None and not random_init:
            return
        try:
            from transformers import CLIPModel
        except ImportError as e:
            print(f"[clip] unavailable: {e}")
            return
        if random_init:
            from transformers import CLIPConfig

            cfg = CLIPConfig(
                projection_dim=64,
                text_config={"hidden_size": 64, "intermediate_size": 128,
                             "num_hidden_layers": 2, "num_attention_heads": 2,
                             "max_position_embeddings": 77,
                             "vocab_size": 49408},
                vision_config={"hidden_size": 64, "intermediate_size": 128,
                               "num_hidden_layers": 2,
                               "num_attention_heads": 2, "image_size": 64,
                               "patch_size": 16})
            self.model = CLIPModel(cfg)
        else:
            self.model = CLIPModel.from_pretrained(model_path)
            try:
                from transformers import CLIPTokenizerFast

                self._tok = CLIPTokenizerFast.from_pretrained(model_path)
            except (ImportError, OSError, ValueError):
                self._tok = None
        self.model.to(self.device).eval()
        for p in self.model.parameters():
            p.requires_grad_(False)
        self.image_size = self.model.config.vision_config.image_size
        if text is not None:
            self.prepare_text(text)
        self.available = True

    def _tokenize(self, text: str) -> torch.Tensor:
        """Token ids [1, T]: the checkpoint's tokenizer where it has one,
        else a deterministic word hash (random_init has no vocab files; the
        ids only need to be a stable function of the text)."""
        if self._tok is not None:
            return self._tok([text], return_tensors="pt", padding=True,
                             truncation=True)["input_ids"]
        vocab = self.model.config.text_config.vocab_size
        ids = [49406]  # startoftext
        for word in text.lower().split()[:30]:
            h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
            ids.append(h % (vocab - 3) + 1)
        ids.append(49407)  # endoftext
        return torch.tensor([ids], dtype=torch.long)

    def prepare_text(self, text: str):
        m = self.model
        with torch.no_grad():
            pooled = m.text_model(
                input_ids=self._tokenize(text).to(self.device)).pooler_output
            feat = m.text_projection(pooled)
            self.text_feat = feat / feat.norm(dim=-1, keepdim=True)
        self.text = text

    def _preprocess(self, img: torch.Tensor) -> torch.Tensor:
        """[H, W, 3] in [0, 1] -> [1, 3, S, S]: a differentiable bilinear
        (antialiased) resize and CLIP's normalization."""
        x = img.permute(2, 0, 1)[None]
        s = self.image_size
        x = F.interpolate(x, size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = torch.tensor(_CLIP_MEAN, dtype=x.dtype,
                            device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(_CLIP_STD, dtype=x.dtype,
                           device=x.device).view(1, 3, 1, 1)
        return (x - mean) / std

    def loss_torch(self, img: torch.Tensor) -> torch.Tensor:
        """-cos(CLIP(img), CLIP(text)) of an image tensor [H, W, 3] on this
        loss's device, differentiable in the image."""
        self._require()
        m = self.model
        pooled = m.vision_model(
            pixel_values=self._preprocess(img)).pooler_output
        feat = m.visual_projection(pooled)
        feat = feat / feat.norm(dim=-1, keepdim=True)
        return -(feat * self.text_feat).sum(-1).mean()

    def __call__(self, image) -> float:
        """image [H, W, 3] in [0, 1] (numpy or tensor) -> the loss, without
        a gradient."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        with torch.no_grad():
            return float(self.loss_torch(image.to(self.device,
                                                  torch.float32)))

    def _require(self):
        if not self.available or self.text_feat is None:
            raise RuntimeError(
                "CLIPLoss needs a prepared model and text: pass model_path "
                "with a local CLIP checkpoint, or random_init=True")
