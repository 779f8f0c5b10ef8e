"""Bundle adjustment: batched Levenberg-Marquardt in place of BundlerLib/g2o.

- `residuals`: reprojection and tether residuals with Jacobians
- `pose_only`: motion-only LM (one camera, fixed points), the tracking path
- `schur`: full BA through the Schur-complement reduced camera system
- `step`: StepBundleAdjustment semantics (Huber schedule, outlier
  extraction with the behind-camera test, persistent lambda)
"""
