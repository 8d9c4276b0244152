"""Hand-written Hopper kernels (csrc/*.cu), their plain PyTorch versions
(ref.py) and the device dispatcher (ops.py).

l2_topk       fused squared-L2 distance tiles + running top-k against a
              SHARED database (flat ground truth, k-means assignment)
bucket_probe  fused IVF probe: per-query bucket distances merged into the
              running top-k (DARTH-on-IVF's hot loop)
gbdt_predict  GBDT ensemble inference (the recall predictor)
"""
