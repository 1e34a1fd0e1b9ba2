/* libhpnn_tpu.h -- alias for the full public header (include/libhpnn.h),
 * the name C programs of the public API (native/train_nn.c,
 * native/run_nn.c) include.  The port's own copy of the JAX package's.
 */
#ifndef LIBHPNN_TPU_H
#define LIBHPNN_TPU_H

#include <libhpnn.h>

#endif /* LIBHPNN_TPU_H */
