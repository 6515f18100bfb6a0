// Inference response: JSON header + binary output sections.
// Parity: ref src/java/.../InferResult.java role.
package torch.client;

import java.nio.ByteBuffer;
import java.nio.ByteOrder;
import java.nio.charset.StandardCharsets;
import java.util.ArrayList;
import java.util.HashMap;
import java.util.List;
import java.util.Map;

public class InferResult {
  private final Json header;
  private final byte[] body;
  private final Map<String, int[]> binary = new HashMap<>();  // off, len

  InferResult(byte[] body, int headerLength) throws InferenceException {
    this.body = body;
    int jsonLen = headerLength > 0 ? headerLength : body.length;
    String json = new String(body, 0, jsonLen, StandardCharsets.UTF_8);
    try {
      this.header = Json.parse(json);
    } catch (RuntimeException e) {
      throw new InferenceException("bad response JSON: " + e.getMessage());
    }
    if (header.has("error"))
      throw new InferenceException(header.at("error").asString());
    int offset = jsonLen;
    for (Json out : header.at("outputs").asArray()) {
      Json params = out.at("parameters");
      if (params.has("binary_data_size")) {
        int size = (int) params.at("binary_data_size").asLong();
        binary.put(out.at("name").asString(), new int[] {offset, size});
        offset += size;
      }
    }
  }

  public String id() { return header.at("id").asString(); }
  public String modelName() { return header.at("model_name").asString(); }

  public long[] shape(String output) throws InferenceException {
    Json out = find(output);
    List<Json> dims = out.at("shape").asArray();
    long[] shape = new long[dims.size()];
    for (int i = 0; i < shape.length; i++) shape[i] = dims.get(i).asLong();
    return shape;
  }

  public DataType datatype(String output) throws InferenceException {
    return DataType.valueOf(find(output).at("datatype").asString());
  }

  public int[] asIntArray(String output) throws InferenceException {
    ByteBuffer buf = rawBuffer(output);
    int[] out = new int[buf.remaining() / 4];
    for (int i = 0; i < out.length; i++) out[i] = buf.getInt();
    return out;
  }

  public float[] asFloatArray(String output) throws InferenceException {
    ByteBuffer buf = rawBuffer(output);
    float[] out = new float[buf.remaining() / 4];
    for (int i = 0; i < out.length; i++) out[i] = buf.getFloat();
    return out;
  }

  public String[] asStringArray(String output) throws InferenceException {
    ByteBuffer buf = rawBuffer(output);
    List<String> out = new ArrayList<>();
    while (buf.remaining() >= 4) {
      int len = buf.getInt();
      byte[] bytes = new byte[len];
      buf.get(bytes);
      out.add(new String(bytes, StandardCharsets.UTF_8));
    }
    return out.toArray(new String[0]);
  }

  private ByteBuffer rawBuffer(String output) throws InferenceException {
    int[] section = binary.get(output);
    if (section != null) {
      return ByteBuffer.wrap(body, section[0], section[1])
          .order(ByteOrder.LITTLE_ENDIAN);
    }
    // JSON data fallback
    Json out = find(output);
    DataType dt = DataType.valueOf(out.at("datatype").asString());
    List<Json> data = out.at("data").asArray();
    if (dt == DataType.BYTES) {
      // re-frame as length-prefixed for asStringArray
      ByteBuffer tmp = ByteBuffer.allocate(totalBytesSize(data))
                           .order(ByteOrder.LITTLE_ENDIAN);
      for (Json v : data) {
        byte[] bytes = v.asString().getBytes(StandardCharsets.UTF_8);
        tmp.putInt(bytes.length);
        tmp.put(bytes);
      }
      tmp.flip();
      return tmp;
    }
    ByteBuffer buf =
        ByteBuffer.allocate(data.size() * Math.max(1, dt.byteSize()))
            .order(ByteOrder.LITTLE_ENDIAN);
    for (Json v : data) {
      switch (dt) {
        case BOOL:
        case INT8:
        case UINT8: buf.put((byte) v.asLong()); break;
        case INT16:
        case UINT16: buf.putShort((short) v.asLong()); break;
        case INT32:
        case UINT32: buf.putInt((int) v.asLong()); break;
        case INT64:
        case UINT64: buf.putLong(v.asLong()); break;
        case FP32: buf.putFloat((float) v.asNumber()); break;
        case FP64: buf.putDouble(v.asNumber()); break;
        default:
          throw new IllegalStateException("unsupported dtype " + dt);
      }
    }
    buf.flip();
    return buf;
  }

  private static int totalBytesSize(List<Json> data) {
    int total = 0;
    for (Json v : data)
      total += 4 + v.asString().getBytes(StandardCharsets.UTF_8).length;
    return total;
  }

  private Json find(String output) throws InferenceException {
    for (Json out : header.at("outputs").asArray()) {
      if (out.at("name").asString().equals(output)) return out;
    }
    throw new InferenceException("output '" + output + "' not found");
  }
}
